#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gms_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Drives the port's paths through the entry points a user calls — triangle
counting on RMAT scale 18 (average degree 16, seed 27491095, the headline
graph of bench.py), k-clique counting on bench.py's three k-clique graphs,
maximal clique enumeration (Bron–Kerbosch) on its RMAT scale 14 graph,
k-clique-star counting on its RMAT scale 12 graph, per-vertex triangle
counts, the triangle-count ordering and the device ADG ordering on RMAT 18,
dense-bitmap triangles and bitmap set counts on RMAT 16, and vertex
similarity and link prediction (bench.py's lp_auc round: the sampled AUC
and the top-q ranking) on RMAT 16, and graph coloring (Jones–Plassmann,
Johansson, Barenboim/Elkin, dense/sparse) on RMAT 16, subgraph isomorphism
(VF2) on RMAT 14 and 17, the compressed graph forms on RMAT 14, and the
GAPBS kernels (BFS, PageRank, connected components, SSSP, betweenness
centrality) on RMAT 18 and on RMAT 14's compressed forms, the direct=True
Bron–Kerbosch variant on RMAT 14 and 12, and the multi-device layer
(parallel/: the sharded k-clique count, triangle count, pair scores and BK
fan-out over torch.distributed, NCCL at world size 1 and gloo at world size
2 on the one card; the ring-streamed vertex-sharded triangle, k-clique and
BK plans and the tuned sharded triangle plan on the same graphs; the dry
run of parallel/dryrun.py) — and holds every hand-written CUDA kernel of those
paths against its plain PyTorch version on the card. Phases, each printing a line and each failing the run (non-zero exit) if it fails:

  1. device and build: card name, power limit, nvcc build of csrc/*.cu;
  2. headline graph: generation and CSR build on the host;
  3. main path, with every launch counter set to 0 just before it: build
     TrianglePlan(g, device="cuda") (materialized) and run it, then the
     gather-mode plan (materialize=False) and run it; both must give the
     golden count 82,647,223, and every kernel must have launched;
  4. each kernel against its plain version on the plan's own arrays at the
     headline shapes, exactly (integers, tolerance 0), with CUDA-event times;
  5. steady-state trial time of both plans; K40's device time over one warm
     VertexShardedTrianglePlan.run at a world of one (no process group)
     under torch.profiler, with the idle share;
  6. small graph (RMAT scale 12) against the host oracle, at hub thresholds
     8, 65 and None, both modes;
  7. the triangle path's launches and the time so far;
  8. k-clique main path, with every k-clique launch counter set to 0 just
     before it: kclique_count(g, k, device="cuda") on the three k-clique
     graphs of bench.py (RMAT 16 k=5, RMAT 13 k=6, RMAT 12 k=8, average
     degree 16, seed 27491095), each against its golden count, after the
     exact degeneracy peel; every k-clique kernel must have launched, K5
     once a chunk of RMAT 16 k=5 (31 launches); the three calls once more,
     warm, under torch.profiler: K5's (k=5), K6's (k >= 6) and K4's device
     time and the idle share;
  9. RMAT 16 k=5 again under the ADG ordering (eps 0.1): the same count;
 10. each k-clique kernel against its plain version, exactly, with
     CUDA-event times: build_local_adj and kclique_dense_count on every
     chunk of RMAT 16 k=5, kc_stack_count on every chunk of RMAT 13 k=6 and
     RMAT 12 k=8 and on the W=256 chunk of K_132 at k=6 (the memory walk);
     build_local_adj also on the first chunk of phase 53's sharded call, at
     its one global W (not on the kernels line); build_local_adj's held
     RMAT 16 chunks also by device time (torch.profiler, 10 warm passes);
     each main-path chunk's K6 time by CUDA events, warm, and its share;
     kclique_dense_count's library figure: gms_tpu's own dense program
     (k_clique.py:578-607) as float32 torch.bmm of each chunk's unpacked
     0/1 adjacency, TF32 off, at k=4 and k=5 (its counts equal K5's; the
     bmm calls alone timed, the median of BMM_REPS after an untimed one,
     beside K5's k=4 time); K5's bound: the AND+popcount words the sums
     need (A_i's non-zero words a pair (i, j), X's a triple (i, j, m),
     counted by the plain version), beside the earlier count of a whole row
     each (i, j, m); its device time over phase 8's warm call beside the
     held one;
 11. small graphs against the host oracle: RMAT 10 at k=3..7, K_7 at
     k=1..8, and K_132 at k=6 against C(132, 6);
 12. Bron–Kerbosch main path, with every BK launch counter and K4's set to
     0 just before it: bron_kerbosch(g, device="cuda", rank=rank) on RMAT 14
     (average degree 16, seed 27491095, the graph of bench.py's maximal
     clique run) after the exact degeneracy peel, against the golden
     165,402,717; the host plan timed apart, the tiers and launches; K4,
     symmetrize_bits, hub_cover_bits and bk_stack_machine must have
     launched, and their entries in the kernels line carry these counts;
     then one warm call under torch.profiler: each BK kernel's device time
     and launches over the whole call (K9 = bk_stack_*), the host time and
     the device's idle share;
 13. RMAT 14 again under the ADG ordering (eps 0.1): the same count;
 14. enumerate mode, with the counters set to 0 again just before its run:
     sink= at RMAT 12 (the rows sum to the count mode's count, every BK
     kernel and K4 launched, decode_clique_members's entry carries this
     run's count, a seeded sample of 1,000 rows are cliques and maximal),
     and collect=True at RMAT 8 against bron_kerbosch_simple (which,
     without a pivot, takes a minute at RMAT 9);
 15. the RMAT 14 call's kernels job by job, with CUDA-event times and
     bounds: symmetrize_bits and hub_cover_bits against their plain
     versions on every job (their kernels-line times are these), and
     bk_stack_machine (count, and emit as sorted rows) on the jobs with
     IN >= 2048 and on the W=128 job with the most cliques up to
     BK_PLAIN_CLIQUES (the plain search would take minutes on the largest);
     every job's bk_stack_machine(stats=) run: the items its warps took and
     the warps' cycle split (walking, pivot, children, leaf filter,
     waiting or donating), printed for the W=128 IN=1024 job and summed;
 16. each BK kernel against its plain version, exactly, with CUDA-event
     times, on every job of RMAT 12, whose enumerate run of phase 14 is
     part of the path. bk_stack_machine's kernels-line times are summed
     over every job of phases 15 and 16 it was held against plain on; its
     bound is the larger of the bytes it reads and writes (bk_stack_bytes:
     the live roots' S0, wvalid, the adj rows of their S0 slots and their
     valid cover rows) over 3.35 TB/s and its operations, the
     popcounts at 16 and the bitwise operations at 64 a clock per SM,
     counted as the function needs them (own_ops: the pivot on cand's
     nonzero words, 2 * WW words a child, the running cover), the plain
     tree's whole count beside it;
 17. k-clique-star main path, with the star launch counters set to 0 just
     before it: kclique_star_list(g, 4, device="cuda", rank=rank,
     mode="count") on RMAT 12 (average degree 16, seed 27491095, the graph
     of bench.py's k-clique-star run) after the exact degeneracy peel,
     against the golden 4,077,953 cliques and 136,080,055 star total; timed
     warm, after one untimed first call (whose time is printed beside), the
     host plan timed apart, the jobs and launches; build_local_univ and
     star_stack must have launched;
 18. RMAT 12 again under the ADG ordering (eps 0.1): the same two numbers;
 19. the identity star_total(k) = (k+1) · kclique_count(g, k+1) at RMAT 12
     for k = 3 and 4 (the star of a k-clique is the set of vertices that
     extend it to a (k+1)-clique);
 20. emit mode at RMAT 12 job by job on the device, with the counters set
     to 0 again just before it: star_fused_chunk(emit=True) and
     decode_star_rows on every job; the rows sum to 4,077,953 and their
     star popcounts to 136,080,055; in a seeded sample of 1,000 rows the
     clique is a clique and the star equals its common neighbourhood less
     the clique; then the same pass once more under torch.profiler:
     decode_star_rows's device time and launches over it (K11 and K12
     beside it, each of the jobs' K11 launches traced), the host time and
     the device's idle share;
 21. list mode: 30-vertex random graphs at k = 2, 3, 4 against
     kclique_star_oracle, and RMAT 10 at k = 3 against the port's own
     device="cpu" run, as sets;
 22. each star kernel against its plain version, exactly, with CUDA-event
     times and bounds: build_local_univ and decode_star_rows on every RMAT
     12 job, star_stack (count, and emit as sorted rows) on every job too;
     its bound is the larger of its bytes over 3.35 TB/s (live0, the live
     roots' S0 and I0, and the two matrices' rows of the slots it searches)
     and its operations, as K9's; the emit pass's bound beside it, the
     larger of the same operations and those bytes plus the rows written
     ((2 * WW + 1) words each);
 23. per-vertex main path, with the triangle launch counters set to 0 just
     before it: triangle_count_per_vertex(g, device="cuda") on phase 2's
     RMAT 18, timed to its read-back, the host plan timed apart; the counts
     sum to 3 x 82,647,223, a seeded sample of 1,000 vertices and the 10 of
     highest degree equal a host recount, and count_dag_edges_per_vertex
     launched once per tier (10 tiers); the call once more, warm, under
     torch.profiler: K14's device time and the idle share;
 24. triangle_count_ordering_rank at RMAT 18: a permutation ordering the
     vertices by (per-vertex count, id);
 25. dense path, the counters set to 0 just before it: triangle_count_dense
     on RMAT 16 equals TrianglePlan's count; the bitmap's bytes
     (536,870,912) and host build time; count_hub_edges launched once;
 26. device ADG at RMAT 18, the ADG counter set to 0 just before each run:
     "avg" and "min" at eps 0.01, 0.1 and 0.5 equal the host
     adg_ordering_rank rank for rank; "prob_min" and "prob_median" give the
     same permutation twice for a seed and, at RMAT 14, pass
     verify_approx_degeneracy_order and equal gms_tpu's ranks (their
     digests, ADG_PROB_GOLDEN: the draws are jax.random's, prng.py); each
     run's rounds (adg_round launches) and time; the main path is the "avg"
     eps 0.1 run, whose launches adg_round's entry in the kernels line
     carries;
 27. bitmap_ops on RMAT 16's bitmap rows, row v against row v+1, the
     counter set to 0 just before: the four counts keep |A∪B| =
     |A|+|B|-|A∩B| and |A∖B| = |A|-|A∩B|, and |A| is v's out-degree;
 28. each of those kernels against its plain version, exactly, with
     CUDA-event times and bounds: count_dag_edges_per_vertex on every RMAT
     18 tier, count_hub_edges on RMAT 16's dense edges (its operations, one
     AND+popcount a word, bound it), bitmap_rows_count on phase 27's rows
     (the two views of one table are read once: their bytes count once),
     adg_round on every round state of the main path's "avg" eps 0.1 run
     (times and bounds summed over its rounds); K14's device time over
     phase 23's warm call beside its held one;
 30. link-prediction main path on RMAT 16 (bench.py's lp_auc protocol: test
     split extract_random_test_edges(g, int(0.01 m), seed=1)), with the
     similarity and link-prediction counters set to 0 just before it:
     AUCPlan(g, train, test, 100,000, metric="jaccard", seed=2) then
     run_steady(8); its eight timed trials' (higher, equal) must be the
     golden LP_GOLDEN and the AUC 0.85176; the host plan, seconds a trial
     and the launches (pair_scores, pair_scores_hub and auc_count 8 each in
     the timed call, 8 in the first call) printed; run(0) equals the plain
     versions' counts;
 31. score_auc for the bench's five metrics under gms_tpu's bench protocol
     (test split seed 0, 100,000 samples): each AUC in [0, 1]; (higher,
     equal) equal to the plain versions' for Jaccard, overlap and CN, the
     AUC within 1e-4 for AA and RA;
 32. vertex_similarity for the seven metrics on RMAT 16: 100,000 uniform
     pairs and 100,000 with a hub end against the plain version (bit for
     bit, AA and RA within rtol 1e-5), a seeded 1,000 against the host
     oracle;
 33. the top-q ranking, bench.py's call, the counters set to 0 just before:
     link_prediction_similarity(train, 100, metric="jaccard") on phase 30's
     train graph must return the 100 pairs of isolated vertices that
     gms_tpu's keyed rule picks (keyed_isolated_topq), all of score 1.0; its
     time and tile_topq's launches (one a u-block); then one warm call
     under torch.profiler: K21's device time summed over its launches, the
     window's host time, device busy time and idle share; then six warm
     calls, each row's range in a chunk from the strip table and by binary
     search alternated (STRIP_TABLE_BYTES 0), K21's device time and the
     host clock of each;
 34. top-q counting against the plain version on the card (float32 matmuls,
     TF32 off; AA and RA summed in ascending neighbour order on both sides):
     CN and AA at RMAT 14, the seven metrics at RMAT 12 with block 512, pairs
     and score bits equal (AA and RA also held to pair_scores_plain within
     rtol 1e-5), and all_pairs_scores on RMAT 12's first 512 rows (its
     counter set to 0 just before: one tile_all_pairs a metric);
 35. each new kernel against its plain version, with CUDA-event times, L2
     flushed, and bounds: pair_scores and pair_scores_hub on phase 30's
     pairs (Jaccard; bytes: the pairs, their deg entries, each distinct row
     to its first SENTINEL, K19's distinct bitmap words probed, the output),
     auc_count on phase 30's scores, tile_topq on every u-block of phase
     33's call (its error 0: pairs and score bits) and of the whole RMAT 14
     CN, AA and q = 10,000 (Jaccard) calls, tile_all_pairs on phase 34's
     block; tile_topq's bound is the function's own (bytes of the CSR,
     indptr and indices, and the degrees read once and the q candidates; or
     the pair finishes, every pair with u < v < n, and the wedges, at the
     32-bit rate), beside it row 14b's bound of record, the id-space bitmap
     layout's (bytes of the strips' rows, or the AND+popcounts of the word
     pairs both non-zero); tile_all_pairs is bound by its AND+popcounts,
     and the library time of both is the float32 torch.matmul of the same
     common counts;
 37. coloring main path on RMAT 16 (bench.py's coloring graph), with every
     coloring launch counter set to 0 just before it:
     jones_plassmann(g, speculative=True, priority="degree") must give 104
     colors and digest c7b066c1de1c6f34 (COLOR_GOLDEN, gms_tpu's on the CPU);
     the first call's time (its dispatch-start states recorded by wrapping
     the module's spec_run for the call),
     the median of 3 warm calls and of 3 host tier builds with their copy,
     the rounds and launches; spec_run (K23) must have launched once a
     dispatch; one warm call under torch.profiler: K23's device time over
     the whole call, its launches and the idle share, beside its bound over
     the whole call (every round of every dispatch, each round's buckets
     counted as phase 41 counts them);
 38. the other deterministic variants at RMAT 16, the counters set to 0
     before each: speculative random, strict JP-LF (its jp_run dispatch
     states recorded), strict random and dense_sparse(g, seed=0), each
     against its digest; jp_run must have launched once a strict JP-LF
     dispatch; one warm strict JP-LF call under torch.profiler: K22's
     device time over the whole call, its launches (one a dispatch) and
     the idle share, beside its bound over the whole call (every round of
     every dispatch, each round's buckets counted as phase 41 counts
     them);
 39. dense_sparse on RMAT 14 with friend_number 32 (its friend components
     fire): 265 colors, digest dc688ce0f6f78322 (its component_step
     states recorded); color_components and K18 (pair_scores) must have
     launched;
 40. the randomized runs at RMAT 16, the counters set to 0 before each
     (their round states and draws recorded): johansson (proper, color <=
     deg), barenboim_elkin "barenboim" (proper, <= Δ+1 colors) and "elkin"
     (both bounds); each color count, time and launches; color_johansson
     and color_one_shot must have launched twice a round (Johansson's pick
     words and round, the one-shot's pick and resolve), whatever the number
     of buckets; then the three on phase 39's
     RMAT 14 against gms_tpu's colors (COLOR_RANDOM_GOLDEN: gms_tpu's keys
     and jax.random's draws, prng.py);
 41. each coloring kernel against its plain version, exactly, on the
     round-start states recorded in 37-40 — the first round and the last
     with an uncolored vertex, every bucket: jp_run on strict JP-LF's
     first and last dispatch (colors and rounds; bytes every round's
     buckets), color_jp (jp_bucket, off the kernels line: no entry point
     runs it) on the first and last round of strict JP-LF (the last
     dispatch stepped to its last round by jp_run),
     spec_run on the speculative main path's first and last dispatch
     (colors and rounds; bytes every round's buckets), its three passes
     (spec_pick, spec_rank, spec_clash, off the kernels line: no entry
     point runs them one by one) on the main path's first and last round,
     color_johansson (johansson_round, a round over every bucket) on
     Johansson's, color_one_shot (one_shot_round: pick and resolve) on
     Barenboim's (and, off the kernels line, on Elkin's), their one-bucket
     entries (johansson_bucket, one_shot_pick, one_shot_resolve, off the
     kernels line: no entry point runs them) on Johansson's and
     Barenboim's, color_components on phase 39's
     first and last label steps; CUDA-event times, L2 flushed, and bytes
     bounds of what each function needs (each row's id, own color and
     output; for an uncolored row its own words and, entry by entry, the
     index word and only the neighbour words whose condition holds, up to
     the entry that decides the row: bucket_bytes); color_components'
     library time is one scatter_reduce_ (amin) over the friend edge list
     a step, on the same two states, each step also timed batched
     (BATCH_STEPS back-to-back calls between one event pair after one
     flush, K25 and the library) and by torch.profiler's device time over
     as many calls, with its row schedule's build time and the Timing
     floor (a 4-byte fill timed as a kernel is). Each
     kernels-line entry takes its launches from the run whose states it
     times;
 42. VF2 main path, bench.py's vf2 round on RMAT 14 (average degree 16,
     seed 27491095): subgraph_isomorphism(g, p, induced=True, limit=1) for
     k4, p4 and c5 in hybrid mode (host_budget=200,000) and device mode
     (host_budget=0), best of 3 warm calls after a first; each mapping must
     be gms_tpu's (VF2_GOLDEN, its mappings on the CPU; the same in both
     modes) and pass verify_mapping; every hybrid call launches nothing;
     the launch counters are set to 0 just before c5's device run, the main
     path, whose level inputs are recorded (wrapping the module's feasible)
     and whose launches vf2_feasible's and vf2_emit's entries carry;
 43. the search branch: c5 in device mode on RMAT 17, whose id-space bitmap
     (2 GB) is over the 1 GB gate, against gms_tpu's [0, 1, 47, 4631,
     51464]; its level inputs recorded;
 44. enumeration (limit=None, non-induced): the triangle on RMAT 14 gives
     6 x 2,819,074 = 16,914,444 mappings, K4 on the largest of RMAT 10-12
     whose mappings fit 1 GB gives 24 x kclique_count(g, 4); all rows
     distinct, a seeded 1,000 pass verify_mapping;
 45. the compressed layer on RMAT 14, K28's counter set to 0 just before:
     KbitGraph, KbitGraphBucketed and HybridGraph built on the host and
     moved to the card; as_csr of each equals the CSR and triangle_count of
     each is 2,819,074; K28 over every row equals PaddedGraph's rows;
     KbitWeightedGraph.weight_rows equals the weights; bits per edge of
     each form;
 46. K26-K28 against their plain versions, exactly, with CUDA-event times,
     L2 flushed, and bytes bounds: vf2_feasible and vf2_emit on the first
     and last level of the c5 runs of phases 42 (bitmap) and 43 (search),
     kbit_decode_rows on RMAT 14's rows, on each filled width bucket's rows
     (8 and 16 bits: its ids fit 14) and on its first 2,048 rows packed at
     k = 24 and 32.
     K26's bytes: M and the candidates, the deg1 entries of the live
     candidates and, check by check in gms_tpu's order, the distinct
     bitmap words or row words (binary-search probes) consulted for the
     candidates still alive, and the mask; K27's: the mask, each child's
     item row once and candidate, the cap x P output; K28's: each row's
     words up to its last live lane, deg, vids and the output. No single
     PyTorch call computes any of the three, so library_ms is null.
 47. GAPBS main path on phase 2's RMAT 18, every GAPBS counter set to 0
     just before it, one call each: bfs(g, 0) direction-optimizing (its
     levels must run push, pull, pull, push, push: f_cap 16,384) and
     pull-only, connected_components, sssp unit and weighted (w = 1 + ((u ^
     v) % 9) per slot), pagerank (20 iterations); gates: scipy's
     shortest_path (173,898 reached), connected_components mapped to each
     component's min id (88,200), dijkstra (max 23, sum 804,946) and a
     vectorised float64 PageRank (rtol 1e-4, atol 1e-7); each call's first
     and best of 3 warm times (host clock to the read-back), the host CSR
     copy timed apart; bfs_pull, frontier_ids, bfs_push, pr_pull, cc_step
     and sssp_step must have launched;
 48. betweenness_centrality(g, num_samples=64, seed=0) at RMAT 18, its
     counters set to 0 just before: max_depth 12, max_depth launches of each
     BC step a batch; its first and best warm time; the kernels against the
     plain version over the same 64 sources, one batch (rtol 1e-4); one
     warm call under torch.profiler: K34's device time (forward and
     backward, main and finish launches) and the idle share; the call's
     scores and the kernels' total the same bits on a second run;
 49. RMAT 14 and phase 45's compressed forms against gms_tpu's digests
     (GAPBS_GOLDEN_14): bfs over the CSR, KbitGraph, KbitGraphBucketed and
     HybridGraph, bfs_kbit (its counter set to 0 just before), connected
     components, sssp unit and weighted, and the KbitWeightedGraph's sssp;
     PageRank's sum and max (rtol 1e-5) and argmax, BC's argmax and sum
     (rtol 1e-4);
 50. K29-K34 against their plain versions on that work, with CUDA-event
     times, L2 flushed, and bytes bounds: bfs_pull on every level of RMAT
     18's pull-only BFS (bytes: dist once, the unreached rows' distinct
     indptr words and entries up to the one that decides them, the
     writes); frontier_ids on the level the d-opt BFS compacts, bfs_push on
     its push levels (the frontier's ids, distinct indptr words and rows,
     each distinct neighbour's dist, the writes), each timed bare (the ids,
     in any order, are sorted only to compare them); bfs_kbit_pull on every level of RMAT 14's KbitGraph (the
     unreached rows' packed words up to the deciding lane); pr_pull on
     PageRank's first and last iteration, cc_step and sssp_step (weighted)
     on their first and last step (indptr, indices, weights, the state and
     the output once); bc_forward and bc_backward as whole passes of
     max_depth steps on phase 48's batch of 64 sources, one bit a source
     (per step one bit a pair of the frontier, each row some pair scans
     read once with its distinct indptr words, the per-pair state words of
     distinct neighbours, the writes; the record's figure, a 4-byte dist
     word a pair a step, printed beside it), and as a note the forward
     steps' sums alone by torch.sparse.mm of the CSR by each step's masked
     sigma [n, 64]. Library time: scatter_reduce_ (amax) of the frontier over the
     edge list for bfs_pull, torch.sparse.mm of the CSR matrix (with the
     division and axpy) for pr_pull, scatter_reduce_ (amin) over the edge
     list for cc_step and sssp_step; no single PyTorch call computes the
     others. pr_pull and the BC steps are held at rtol 1e-5 and 1e-4 (both
     sides sum each row in float64 and round it once, but the two float64
     sums may still round apart); the rest
     exactly. pr_pull runs on the row schedule pagerank builds (its build
     time printed), gives the same bits on repeated runs at RMAT 18, and
     is timed batched beside torch.sparse.mm's pull (BATCH_STEPS
     back-to-back iterations), by torch.profiler's device time over as
     many, and beside the Timing floor.

 51. direct Bron–Kerbosch main path on phase 12's RMAT 14, with every BK
     launch counter and K4's set to 0 just before it:
     bron_kerbosch(g, device="cuda", rank=rank, direct=True), timed warm
     after one first call, must give BK_GOLDEN; the roots of degree above
     1024 take the fused path (their share of the count printed), and
     init_items, bk_direct_stack and K4 must have launched; the fused
     default call timed beside it; hub_threshold=64 gives BK_GOLDEN too;
     RMAT 12 gives 725,641 (tests/test_soak.py's reference count); one
     warm direct call under torch.profiler, as phase 12's;
 52. the main path's RMAT 14 direct jobs: K36 bk_direct_stack timed on
     each whole, with its stats= run: the items its warps took (the root
     items and the queued nodes), the most one warp took and the warps'
     cycle split, as phase 15's; K35 init_items against its
     plain version on each, exactly, its kernels-line times and bound
     (bytes: the roots, their rows' first min(W, deg + 1) slots, the ranks
     read, the two bitsets written) summed over them; K36 against its plain
     version, exactly (count and overflow), on each job whole while its
     cliques times W * WW stay within BK_DIRECT_PLAIN_WORDS (W <= 256), the
     wider ones (W = 512 and 1024, whose paths lie in device memory) cut to
     their roots in job order within it, after K36 root by root has summed
     to the job's count (direct_cut); its kernels-line times and bound
     summed over those compared runs, the bound the larger of bytes (the
     adj rows of each live root's slots below its degree, the live roots'
     bitsets) and its popcounts at 16 and bitwise operations at 64 a clock
     per SM, as the function needs them (own_ops), the plain tree's whole
     count beside it;
 53. sharded_kclique_count at world size 1 over NCCL (its store on
     127.0.0.1) on RMAT 16, k = 5, with the k-clique counters
     set to 0 just before it: 4,600,426,489 (KCLIQUE_RUNS); its chunks and
     cap doublings; timed warm beside kclique_count on the same graph;
     build_local_adj, expand_level and total_popcount must have launched,
     build_local_adj once a chunk (it builds a chunk's adjacency before
     the chunk's doublings), in the first call and in the profiled one;
     one warm call under torch.profiler: K37's device time (its expand and
     clear kernels), K4's and K38's, summed over their launches, and the
     device's idle share over the window; K4's device time beside its
     bound over the call's chunks (local_adj_bytes at the global W);
     K37 expand_level against its plain version, exactly (the four
     outputs), on every level of the first chunk's first run (a level there
     has cap below n_children) and of its last run (the caps that fit),
     with the live count the main path hands each level and without it
     (level 1's grid at least one block an SM), K38 total_popcount on the
     last level; bounds: K37 the larger of bytes (the live rows of S and R,
     each adj row the set bits need, every row of S_out and R_out written)
     and its AND+popcounts (WW a set bit) at 16 a clock per SM, K38 bytes;
     K37's zero fill apart: its kernels' device time on the held levels at
     their caps and at cap = the survivors (no zero row), and the bytes of
     survivors' and zero rows over a warm call's levels;
 54. the same group: sharded_triangle_count on phase 2's RMAT 18 gives
     82,647,223; sharded_pair_scores (Jaccard) equals pair_scores bit for
     bit on phase 30's RMAT 16 pairs; sharded_bron_kerbosch_count(g,
     ["cuda:0"]) on RMAT 14 gives BK_GOLDEN; the world-size-1 counts and
     warm times of phase 55's two calls; then the group is destroyed;
 55. world size 2 on the one card: two spawned processes joined over gloo
     (NCCL takes one rank a GPU) each run sharded_triangle_count on RMAT 16
     and sharded_kclique_count on RMAT 12, k = 5, twice; both ranks' counts
     must equal phase 54's world-size-1 counts; the warm times beside
     world size 1's, and how many collectives gloo took through the host
     (Mesh.staged);
 56. the sharded plans' main path at world size 1 over NCCL, with every
     launch counter set to 0 just before it: VertexShardedTrianglePlan and
     ShardedTrianglePlan on phase 2's RMAT 18 (82,647,223),
     VertexShardedKCliquePlan on KCLIQUE_RUNS (root chunks of 1,024 at RMAT
     16, RING_CHUNK elsewhere) and at k = 3 on RMAT 12 (the host triangle
     oracle; it puts K38 on the path), VertexShardedBKPlan on RMAT 12
     (725,641); each built, run, and run again timed warm beside its
     single-device call (TrianglePlan in gather mode, kclique_count,
     bron_kerbosch); K39, K40, K1, K2, K5, K6, K7, K9 and K38 must have
     launched;
 57. K40 count_dag_edges_cross against its plain version, exactly, on the
     RMAT 18 vertex-sharded run's rotation with the plan's schedule (its
     bound the function's bytes, the schedule's own bytes beside it), and
     K39 member_pack on every
     (chunk, hop, pack) of the RMAT 12 BK and RMAT 13 k=6 runs, with
     CUDA-event times and byte bounds (each distinct row read to its first
     SENTINEL, the selected slots' locs, the outputs; beside it the bytes
     with each visiting row read only to the entry that passes its roots'
     last live value, where the kernel's walk stops); the kernels line's
     launches are those runs' launches, and must equal the calls compared;
     then, for correctness only, K40 on RMAT 18 split over two owners (the
     two buckets whose rows come from the other owner's shard, a table of
     its own) and the ring path's finish kernels on the first ring-built
     chunk of each plan (K38 at k = 3, K5 at RMAT 16 k = 5, K6 at RMAT 13
     k = 6, K7 and K9 with M at RMAT 12), each against its plain version,
     exactly;
 58. world size 2 on the one card over gloo: every plan of phase 56 in two
     spawned ranks, twice; both ranks' counts must equal the goldens; the
     warm times beside world size 1's and the single-device calls, and the
     collectives and ring hops gloo took through the host (Mesh.staged);
 59. the port's dryrun_multichip(2) (parallel/dryrun.py), two gloo ranks on
     this card: every sharded path on RMAT 7 against the host oracles, and
     the vertex-sharded tables shrinking against a mesh of one.

The line before the last is a JSON object describing every kernel; the last
is {"ok": true, "device": {...}}. Imports nothing of jax or gms_tpu.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import math
import os
import statistics
import subprocess
import time

import numpy as np

import torch

GOLDEN = 82_647_223          # triangles, RMAT-18 deg 16 seed 27491095
SCALE, DEGREE, SEED = 18, 16, 27491095
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
# Results per clock per SM at compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instructions throughput table): __popc, the rate of an
# AND+popcount word operation, and 32-bit bitwise AND/OR/XOR
POPC_PER_CLOCK_PER_SM = 16
BITWISE_PER_CLOCK_PER_SM = 64
KERNEL_REPS, PLAIN_REPS, STEADY_TRIALS = 10, 3, 20
# back-to-back calls of a batched figure (one event pair, one flush)
BATCH_STEPS = 100
# floats of a float32 torch.bmm operand slice in row 10b's library figure,
# and the timed calls of each slice (their median; one untimed call first)
BMM_BUDGET, BMM_REPS = 1 << 28, 3
# the bare names of K21's, K37's, K34's and K6's kernels in a profiler
# window (K6's walk: the register walk at W <= 128, else the memory walk)
K21_KERNELS = ("topq_kernel",)
K37_KERNELS = ("expand_kernel", "clear_kernel")
K34_FORWARD = ("bc_forward_kernel", "bc_forward_finish")
K34_BACKWARD = ("bc_backward_kernel", "bc_backward_finish")
K6_KERNELS = ("stack_reg_kernel", "stack_kernel", "count_kernel",
              "root_offsets_kernel")
# K5's (rows_kernel at W <= 256, rows_any_kernel wider, popcount_kernel at
# k = 3) and K14's kernels, and their launches on the main path: one a chunk
# of RMAT-16 k=5 (phase 8), one a tier of RMAT-18 (phase 23)
K5_KERNELS = ("rows_kernel", "rows_any_kernel", "popcount_kernel")
K14_KERNELS = ("vertex_kernel",)
K5_MAIN_LAUNCHES, K14_MAIN_LAUNCHES = 31, 10
# k-clique graphs of bench.py: (RMAT scale, k, golden count of BENCH_r05)
KCLIQUE_RUNS = ((16, 5, 4_600_426_489), (13, 6, 681_595_966),
                (12, 8, 2_339_107_240))

# the kernels of the total triangle count (phase 3)
TC_PATH = ("count_tier_mat", "count_hub_groups_mat", "build_hub_rows",
           "count_dag_edges", "count_hub_groups")
# the kernels of kclique_count (phase 8)
KCLIQUE_PATH = ("build_local_adj", "kclique_dense_count", "kc_stack_count")

# kernel -> (source, gms_tpu program it replaces)
KERNELS = {
    "count_tier_mat": ("gms_tpu_torch/csrc/tier_intersect.cu",
                       "gms_tpu/algorithms/triangle_count.py:383"),
    "count_hub_groups_mat": ("gms_tpu_torch/csrc/hub_popcount.cu",
                             "gms_tpu/algorithms/triangle_count.py:359"),
    "build_hub_rows": ("gms_tpu_torch/csrc/hub_rows.cu",
                       "gms_tpu/algorithms/triangle_count.py:219"),
    "count_dag_edges": ("gms_tpu_torch/csrc/tier_intersect.cu",
                        "gms_tpu/algorithms/triangle_count.py:99"),
    "count_hub_groups": ("gms_tpu_torch/csrc/hub_popcount.cu",
                         "gms_tpu/algorithms/triangle_count.py:239"),
    "build_local_adj": ("gms_tpu_torch/csrc/local_adj.cu",
                        "gms_tpu/algorithms/k_clique.py:82"),
    "kclique_dense_count": ("gms_tpu_torch/csrc/kclique_dense.cu",
                            "gms_tpu/algorithms/k_clique.py:548"),
    "kc_stack_count": ("gms_tpu_torch/csrc/kclique_stack.cu",
                       "gms_tpu/algorithms/k_clique.py:343"),
    "symmetrize_bits": ("gms_tpu_torch/csrc/bk_symmetrize.cu",
                        "gms_tpu/algorithms/bron_kerbosch.py:406"),
    "hub_cover_bits": ("gms_tpu_torch/csrc/bk_cover.cu",
                       "gms_tpu/algorithms/bron_kerbosch.py:376"),
    "bk_stack_machine": ("gms_tpu_torch/csrc/bk_stack.cu",
                         "gms_tpu/algorithms/bron_kerbosch.py:550"),
    "decode_clique_members": ("gms_tpu_torch/csrc/bk_decode.cu",
                              "gms_tpu/algorithms/bron_kerbosch.py:832"),
    "build_local_univ": ("gms_tpu_torch/csrc/star_univ.cu",
                         "gms_tpu/algorithms/k_clique_star.py:54"),
    "star_stack": ("gms_tpu_torch/csrc/star_stack.cu",
                   "gms_tpu/algorithms/k_clique_star.py:137"),
    "decode_star_rows": ("gms_tpu_torch/csrc/star_decode.cu",
                         "gms_tpu/algorithms/k_clique_star.py:346"),
    "count_dag_edges_per_vertex": ("gms_tpu_torch/csrc/tier_intersect.cu",
                                   "gms_tpu/algorithms/triangle_count.py:129"),
    "count_hub_edges": ("gms_tpu_torch/csrc/bitmap_count.cu",
                        "gms_tpu/algorithms/triangle_count.py:184"),
    "bitmap_rows_count": ("gms_tpu_torch/csrc/bitmap_count.cu",
                          "gms_tpu/sets/bitmap_ops.py:22"),
    "adg_round": ("gms_tpu_torch/csrc/adg_round.cu",
                  "gms_tpu/preprocessing/degeneracy.py:178"),
    "pair_scores": ("gms_tpu_torch/csrc/pair_scores.cu",
                    "gms_tpu/algorithms/similarity.py:51"),
    "pair_scores_hub": ("gms_tpu_torch/csrc/pair_scores.cu",
                        "gms_tpu/algorithms/similarity.py:94"),
    "auc_count": ("gms_tpu_torch/csrc/auc_count.cu",
                  "gms_tpu/algorithms/link_prediction.py:208"),
    "tile_topq": ("gms_tpu_torch/csrc/tile_scores.cu",
                  "gms_tpu/algorithms/link_prediction.py:471"),
    "tile_all_pairs": ("gms_tpu_torch/csrc/tile_scores.cu",
                       "gms_tpu/algorithms/similarity.py:115"),
    "jp_run": ("gms_tpu_torch/csrc/color_jp.cu",
               "gms_tpu/algorithms/coloring.py:272"),
    "spec_run": ("gms_tpu_torch/csrc/color_spec.cu",
                 "gms_tpu/algorithms/coloring.py:257"),
    "color_johansson": ("gms_tpu_torch/csrc/color_random.cu",
                        "gms_tpu/algorithms/coloring.py:127"),
    "color_one_shot": ("gms_tpu_torch/csrc/color_random.cu",
                       "gms_tpu/algorithms/coloring.py:404"),
    "color_components": ("gms_tpu_torch/csrc/color_components.cu",
                         "gms_tpu/algorithms/coloring.py:486"),
    "vf2_feasible": ("gms_tpu_torch/csrc/vf2_feasible.cu",
                     "gms_tpu/algorithms/subgraph_iso.py:81"),
    "vf2_emit": ("gms_tpu_torch/csrc/vf2_emit.cu",
                 "gms_tpu/algorithms/subgraph_iso.py:128"),
    "kbit_decode_rows": ("gms_tpu_torch/csrc/kbit_decode.cu",
                         "gms_tpu/graphs/compressed.py:43"),
    "bfs_pull": ("gms_tpu_torch/csrc/gapbs_bfs.cu",
                 "gms_tpu/algorithms/gapbs.py:85"),
    "frontier_ids": ("gms_tpu_torch/csrc/gapbs_bfs.cu",
                     "gms_tpu/algorithms/gapbs.py:108"),
    "bfs_push": ("gms_tpu_torch/csrc/gapbs_bfs.cu",
                 "gms_tpu/algorithms/gapbs.py:108"),
    "bfs_kbit_pull": ("gms_tpu_torch/csrc/gapbs_kbit_bfs.cu",
                      "gms_tpu/algorithms/gapbs.py:185"),
    "pr_pull": ("gms_tpu_torch/csrc/gapbs_pr.cu",
                "gms_tpu/algorithms/gapbs.py:216"),
    "cc_step": ("gms_tpu_torch/csrc/gapbs_min.cu",
                "gms_tpu/algorithms/gapbs.py:245"),
    "sssp_step": ("gms_tpu_torch/csrc/gapbs_min.cu",
                  "gms_tpu/algorithms/gapbs.py:275"),
    "bc_forward": ("gms_tpu_torch/csrc/gapbs_bc.cu",
                   "gms_tpu/algorithms/gapbs.py:337"),
    "bc_backward": ("gms_tpu_torch/csrc/gapbs_bc.cu",
                    "gms_tpu/algorithms/gapbs.py:375"),
    "init_items": ("gms_tpu_torch/csrc/bk_init.cu",
                   "gms_tpu/algorithms/bron_kerbosch.py:254"),
    "bk_direct_stack": ("gms_tpu_torch/csrc/bk_direct.cu",
                        "gms_tpu/algorithms/bron_kerbosch.py:131"),
    "expand_level": ("gms_tpu_torch/csrc/kc_expand.cu",
                     "gms_tpu/algorithms/k_clique.py:161"),
    "total_popcount": ("gms_tpu_torch/csrc/popcount_sum.cu",
                       "gms_tpu/algorithms/k_clique.py:209"),
    "member_pack": ("gms_tpu_torch/csrc/ring_member.cu",
                    "gms_tpu/parallel/sharding.py:379"),
    "count_dag_edges_cross": ("gms_tpu_torch/csrc/tier_intersect.cu",
                              "gms_tpu/parallel/sharding.py:206"),
}
BK_GOLDEN = 165_402_717      # maximal cliques, RMAT-14 deg 16 (BENCH_r05)
BK_SCALE, BK_SMALL, BK_SAMPLE = 14, 12, 1000
# the plain K9 is held to the kernel on RMAT 14's W=128 job with the most
# cliques up to this many (the plain search takes minutes on the largest)
BK_PLAIN_CLIQUES = 1_000_000
# k-clique-stars at RMAT-12, k=4 (BENCH_extra.json): cliques, star total
STAR_SCALE, STAR_K, STAR_GOLDEN = 12, 4, (4_077_953, 136_080_055)
STAR_SAMPLE, STAR_SMALL = 1000, 10
# phases 23-28: per-vertex triangles at RMAT-18 (Σ = 3 x GOLDEN), dense
# bitmap triangles and bitmap_ops at RMAT-16, device ADG at RMAT-18 (the
# sampled boundaries verified at RMAT-14)
PV_SAMPLE, PV_TOP = 1000, 10
DENSE_SCALE, DENSE_BYTES = 16, 536_870_912
ADG_EPS, ADG_VERIFY_SCALE = (0.01, 0.1, 0.5), 14
ADG_MAIN = ("avg", 0.1)      # the device ADG run whose launches K17 reports
# phases 30-35: link prediction on RMAT-16 (bench.py's lp_auc round: test
# split seed 1, AUCPlan seed 2, Jaccard, 100,000 samples, run_steady(8));
# the (higher, equal) of run_steady's 8 timed trials, from shift 1, exact on
# any device (Jaccard scores are exact ratios, the sampling numpy)
LP_SCALE, LP_SAMPLES, LP_TRIALS = 16, 100_000, 8
LP_GOLDEN = ((81927, 6611), (81932, 6586), (81913, 6637), (81920, 6646),
             (81925, 6636), (81908, 6614), (81949, 6561), (81846, 6660))
LP_Q, LP_BLOCK = 100, 2048   # bench.py's top-q ranking call
LP_BIG_Q = 10_000            # a top-q above one CTA's shared memory
LP_PAIRS, LP_ORACLE = 100_000, 1000
LP_COUNT_SCALE, LP_SMALL_SCALE, LP_SMALL_BLOCK = 14, 12, 512
LP_BENCH_METRICS = ("jaccard", "overlap", "adamic_adar", "resource",
                    "common_neighbors")
# phases 37-41: coloring on RMAT-16 (bench.py's coloring graph) and
# dense_sparse on RMAT-14 with friend_number 32; goldens (colors, digest:
# the first 16 hex digits of sha256 over the int32 colors) of gms_tpu on the
# CPU
COLOR_SCALE, COLOR_DS_SCALE, COLOR_DS_FRIENDS, COLOR_WARM = 16, 14, 32, 3
COLOR_GOLDEN = {
    "spec-lf": ({"speculative": True, "priority": "degree"}, 104,
                "c7b066c1de1c6f34"),
    "spec-random": ({"speculative": True}, 145, "373936d8668860a3"),
    "strict-lf": ({"priority": "degree"}, 82, "8c0f69ed106f236d"),
    "strict-random": ({"priority": "random"}, 111, "17b30d7e3092b7c3"),
}
COLOR_DS_GOLDEN = ((111, "17b30d7e3092b7c3"), (265, "dc688ce0f6f78322"))
# phases 42-46: VF2 on RMAT-14 (bench.py's vf2 round: induced, limit=1) and
# RMAT-17 (the search branch), gms_tpu's first mappings on the CPU, the same
# in hybrid and device mode; enumeration against 6 x triangles and 24 x K4
# (the largest RMAT 10-12 whose mappings fit VF2_ENUM_BYTES); the compressed
# forms of RMAT-14 against its triangle count
VF2_SCALE, VF2_SEARCH_SCALE, VF2_SAMPLE = 14, 17, 1000
VF2_GOLDEN = {"k4": [0, 1, 2, 3], "p4": [43, 0, 1, 15],
              "c5": [0, 1, 15, 748, 9270]}
VF2_SEARCH_GOLDEN = [0, 1, 47, 4631, 51464]
KBIT_TRI_GOLDEN = 2_819_074   # triangles, RMAT-14 deg 16 seed 27491095
VF2_TRI_GOLDEN = 6 * KBIT_TRI_GOLDEN
VF2_ENUM_BYTES = 1 << 30
VF2_WIDE_ROWS = 2048          # RMAT-14 rows K28 also decodes at k = 24, 32
# the randomized colorings of RMAT-14 (phase 39's graph, seed 0) and its
# sampled device ADG ranks (eps 0.1, seed SEED): gms_tpu's on the CPU (its
# one-shot round's [V, D_pad, cw] one-hot does not run at RMAT-16 there)
COLOR_RANDOM_GOLDEN = {"johansson": (366, "5cc27b172fcfeac7"),
                       "barenboim": (3546, "61ae6153572d3e70"),
                       "elkin": (359, "d53ba90684225ee8")}
ADG_PROB_GOLDEN = {"prob_min": "9329e06f63e07fe6",
                   "prob_median": "8dbdee0e0aa1baa2"}
# phases 47-50: the GAPBS kernels on RMAT-18 (scipy's answers) and the
# compressed forms of RMAT-14 (gms_tpu's digests on the CPU)
GAPBS_DIRECTIONS = ["push", "pull", "pull", "push", "push"]
GAPBS_REACHED, GAPBS_COMPONENTS = 173_898, 88_200
GAPBS_SSSP = (23, 804_946)    # weighted SSSP from 0: max, sum over reached
GAPBS_BC_DEPTH = 12           # min(n, max(4, 2 (ecc(0) + 2)))
GAPBS_GOLDEN_14 = {"bfs": "250a4c7a40d80c31", "bfs_kbit": "250a4c7a40d80c31",
                   "cc": "d5266183761978d8", "sssp": "b25bf5b46229f421",
                   "sssp weighted": "0d84116ab140d598"}
# gms_tpu's PageRank (20 iterations: sum, argmax, max) and sampled BC
# (num_samples 64, seed 0: argmax, sum) at RMAT-14
PR_GOLDEN_14 = (0.7995363473892212, 0, 0.0065852003172039986)
BC_GOLDEN_14 = (0, 18.94045066833496)
BC_SAMPLES = 64
INT32_MAX = int(np.iinfo(np.int32).max)   # unreached (gms_tpu's _INF)
# phases 51-55: the direct BK variant (RMAT 14: BK_GOLDEN, also with
# hub_threshold 64; RMAT 12: tests/test_soak.py's count against the
# reference binary) and the multi-device layer (world size 1 over NCCL,
# world size 2 over gloo on the one card)
BK_DIRECT_SMALL_GOLDEN = 725_641
BK_DIRECT_HUB = 64
# phase 52 holds K36 to its plain version on a job whole while its cliques
# times W * WW (the words the plain search gathers a node) stay within
# this, else on the job's roots cut to it (direct_cut)
BK_DIRECT_PLAIN_WORDS = 1 << 30
MULTI_TC_SCALE, MULTI_KC_SCALE, MULTI_K = 16, 12, 5
# phases 56-59: the ring-streamed and tuned sharded plans. Root chunks of
# the k-clique and BK plans (gms_tpu's default of 64 would take 456 chunks,
# each N hops, at RMAT 16); the k = 3 ring run that puts K38 on the path
RING_CHUNK, RING_CHUNK16, RING_K3_SCALE = 512, 1024, 12


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def sm_rate(per_clock_per_sm: int) -> float:
    """Operations per second of card 0 at `per_clock_per_sm` results per
    clock per SM and its maximum SM clock."""
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return per_clock_per_sm * sms * mhz * 1e6


class Timing:
    """Median CUDA-event time of a call, with L2 flushed before each rep:
    on the main path every operand stream is far larger than the 50 MB L2,
    so each launch finds its inputs cold."""

    def __init__(self):
        self.flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")

    def ms(self, fn, reps: int, setup=None) -> float:
        """fn must have run once already (compare runs it to check it);
        setup(), untimed, runs before each rep."""
        times = []
        for _ in range(reps):
            if setup is not None:
                setup()
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def floor_ms(timing) -> float:
    """The Timing protocol's floor: a 4-byte fill timed as a kernel is."""
    word = torch.zeros(1, dtype=torch.int32, device="cuda")
    word.fill_(1)
    return timing.ms(lambda: word.fill_(1), KERNEL_REPS)


def event_ms(fn) -> float:
    """One call of fn timed by CUDA events, nothing flushed."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def batched_ms(timing, fn, steps: int = BATCH_STEPS) -> float:
    """ms a call over `steps` back-to-back calls of fn between one event
    pair, after one flush (a warm-up call first): what a loop of such calls
    costs a step, launch overhead included."""
    fn()
    timing.flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def device_us(fn, calls: int = BATCH_STEPS) -> tuple:
    """(device µs a call, {kernel: µs a call}) of `calls` back-to-back
    calls of fn (a warm-up call first), from torch.profiler's trace: the
    device's own events only (a host op's device time is its kernels'),
    names cut to 48 characters and summed; (None, {}) where the trace holds
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            per[e.key[:48]] = per.get(e.key[:48], 0.0) + t / calls
    per = {k: round(t, 3) for k, t in per.items()}
    return (round(sum(per.values()), 3) if per else None), per


def walk_split(stats) -> str:
    """A K9 or K36 stats= run's items and its per-warp cycle split."""
    cyc = stats["cycles"]
    tot = sum(cyc.values())
    parts = ", ".join(f"{k} {v / max(tot, 1):.4f}" for k, v in cyc.items())
    return (f"items {stats['items']} over {stats['warps']} warps, at most "
            f"{stats['max_items']} a warp; {tot} warp cycles: {parts}")


def add_split(acc, stats) -> None:
    """Sums a stats= run's items and cycles into acc."""
    acc["items"] = acc.get("items", 0) + stats["items"]
    for k in ("max_items", "warps"):
        acc[k] = max(acc.get(k, 0), stats[k])
    cyc = acc.setdefault("cycles", {})
    for k, v in stats["cycles"].items():
        cyc[k] = cyc.get(k, 0) + v


def schedule_build(indptr, reps: int = 5):
    """(the row schedule of indptr, the median host ms of `reps` builds,
    each synchronised)."""
    from gms_tpu_torch.graphs.row_schedule import build_row_schedule

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched = build_row_schedule(indptr)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sched, statistics.median(times)


def max_abs_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return int((got.long() - want.long()).abs().max())


def compare(timing, calls, *, ops_rate=None, plain_reps=PLAIN_REPS,
            err_fn=max_abs_err):
    """calls: [(label, kernel_fn, plain_fn, bytes[, ops])] of one kernel on
    one trial; prints one line per call. Both functions run once for the
    comparison (err_fn of their outputs), which warms them up for the
    timing.

    Returns (max_abs_err, kernel_ms, plain_ms, bound_ms, bound_by), each
    summed (the error maximised) over the calls. A call's bound is the larger
    of its bytes (the least it must move, see data_words) over 3.35 TB/s and
    its word operations over `ops_rate`; bound_by names the larger sum."""
    err, k_ms, p_ms, bound, by_ops, by_bytes = 0, 0.0, 0.0, 0.0, 0.0, 0.0
    for label, kernel, plain, nbytes, *ops in calls:
        got, want = kernel(), plain()
        diff = err_fn(got, want)
        kt = timing.ms(kernel, KERNEL_REPS)
        pt = timing.ms(plain, plain_reps)
        bt = nbytes / HBM_BYTES_PER_S * 1e3
        ot = ops[0] / ops_rate * 1e3 if ops else 0.0
        ops_note = f", {ops[0]} word ops -> {ot:.4f} ms" if ops else ""
        print(f"    {label}: max_abs_err {diff}, kernel {kt:.4f} ms, bound "
              f"{max(bt, ot):.4f} ms ({nbytes} bytes -> {bt:.4f} ms"
              f"{ops_note}), plain {pt:.4f} ms")
        err, k_ms, p_ms = max(err, diff), k_ms + kt, p_ms + pt
        bound += max(bt, ot)
        by_ops, by_bytes = by_ops + ot, by_bytes + bt
    return (err, k_ms, p_ms, bound,
            "operations" if by_ops > by_bytes else "bytes")


# Bytes of a kernel's bound: the words that carry data, each read once, plus
# the index arrays and the output. A sorted row carries data up to and
# including its first SENTINEL (the merge stops there), or to the full width
# when it fills it; padding edges and guard slots carry none. Every kernel
# does at most one 32-bit operation per word it reads, and 67e12 op/s (the
# data sheet's 32-bit rate outside the tensor cores) is 80 times 3.35e12 B/s
# over 4 B words, so bytes bound all five.

def data_words(deg, ids, width: int) -> int:
    """Data words of the rows `ids` (with repeats) sliced to `width`."""
    return int((deg[ids.long()].long() + 1).clamp(max=width).sum())


def distinct_data_words(deg, uses) -> int:
    """Data words of each distinct row once, at the widest of the widths it
    is used with; uses: [(ids, width)]."""
    ids = torch.cat([i.reshape(-1).long() for i, _ in uses])
    width = torch.cat([torch.full((i.numel(),), w, dtype=torch.long,
                                  device=ids.device) for i, w in uses])
    widest = torch.zeros(deg.numel(), dtype=torch.long, device=ids.device)
    widest.scatter_reduce_(0, ids, width, "amax")
    return int(torch.minimum(deg.long() + 1, widest).sum())


def distinct_rows(guard: int, *ids) -> int:
    """Distinct rows named by `ids`, the all-zero guard row left out."""
    rows = torch.unique(torch.cat([i.reshape(-1) for i in ids]))
    return int((rows != guard).sum())


def kernel_entry(name, launches, err, k_ms, p_ms, bound_ms, by,
                 library_ms=None) -> dict:
    """One kernel's entry of the kernels line. library_ms is the time of the
    one PyTorch call that computes the same function, where there is one
    (K21's common counts are a float32 matmul); no single call computes the
    others."""
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms}


def tiers(chunks, pad_id) -> str:
    """'W: chunks / real roots' of each tier width of a k-clique plan."""
    out = {}
    for chunk, ww in chunks:
        c, r = out.get(32 * ww, (0, 0))
        out[32 * ww] = (c + 1, r + int((chunk != pad_id).sum()))
    return " · ".join(f"{w}: {c} / {r}" for w, (c, r) in sorted(out.items()))


def local_adj_bytes(pg, chunk, ww) -> int:
    """K4's bytes: each distinct row it reads (the roots' and their
    neighbours'), up to and including its first SENTINEL, the roots, and the
    adj and S0 words written."""
    from gms_tpu_torch.graphs.tiles import SENTINEL
    nbr, v_pad = pg.nbr, pg.v_pad
    roots = chunk.long().clamp(0, v_pad - 1)
    r_nbr = nbr[roots, :min(32 * ww, nbr.shape[1])]
    rows = torch.cat([roots, r_nbr[r_nbr != SENTINEL].long()])
    words = data_words(pg.deg, torch.unique(rows), nbr.shape[1])
    c = chunk.numel()
    return (words + c + c * 32 * ww * ww + c * ww) * 4


def bmm_count(kc, adj, k: int):
    """(count, ms) of gms_tpu's dense program (k_clique.py:578-607) on one
    chunk in torch: Σ A⊙(A@A) (k=4) or Σ M⊙(M@A) (k=5), M[b, (i, j), l] =
    A_ij A_il A_jl, with A the chunk's local DAG adjacency unpacked to
    float32 0/1 and the products float32 torch.bmm, TF32 off: exact, every
    product entry at most W < 2^24, the masked sums in float64. ms: CUDA
    events around the bmm calls alone (the unpack, M and the masked sums
    untimed), over slices of at most BMM_BUDGET floats, each slice's the
    median of BMM_REPS calls after an untimed one (the process's first bmm
    sets up cuBLAS)."""
    C, W, _ = adj.shape
    A = kc.unpack_bits(adj).float()
    group = max(1, BMM_BUDGET // (W ** (k - 2)))
    total, ms = 0, 0.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for c0 in range(0, C, group):
        Ag = A[c0:c0 + group]
        L = Ag if k == 4 else (Ag[:, :, :, None] * Ag[:, :, None, :]
                               * Ag[:, None, :, :]).reshape(-1, W * W, W)
        Q = torch.bmm(L, Ag)
        times = []
        for _ in range(BMM_REPS):
            start.record()
            Q = torch.bmm(L, Ag)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms += statistics.median(times)
        total += int((L * Q).sum(dtype=torch.float64))
        del L, Q
    return total, ms


def dense_library(timing, kc, adjs, k4) -> float:
    """Row 10b's library figure: torch.bmm of every chunk K5 is held on, at
    k = 4 (beside K5's k = 4 time, taken here) and k = 5, each count equal
    to K5's; returns the k = 5 ms, the work K5's kernels-line time covers."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    lib = {4: 0.0, 5: 0.0}
    k4_ms = 0.0
    for (a, _), n4 in zip(adjs, k4):
        n5 = int(kc.kclique_dense_count(a, k=5))
        for k, want in ((4, n4), (5, n5)):
            got, ms = bmm_count(kc, a, k)
            check(got == want, f"torch.bmm's k={k} count {got} != K5's {want}")
            lib[k] += ms
        k4_ms += timing.ms(lambda a=a: kc.kclique_dense_count(a, k=4),
                           KERNEL_REPS)
    print(f"[10] kclique_dense_count's library figure, float32 torch.bmm "
          f"(TF32 off) on its {len(adjs)} chunks, median of {BMM_REPS} "
          f"after a warm-up, counts equal to K5's: k=4 "
          f"{lib[4]:.4f} ms (K5 at k=4 {k4_ms:.4f} ms), k=5 {lib[5]:.4f} ms "
          f"| {card_line()}")
    return lib[5]


def kclique_phases(timing, report) -> None:
    """Phases 8-11: the k-clique path (see the module docstring)."""
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.bench.profiling import profile_window, window_lines
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.preprocessing import degeneracy

    graphs = {}
    for scale, k, golden in KCLIQUE_RUNS:
        t0 = time.perf_counter()
        g = build_csr(generate_rmat_el(scale, DEGREE, seed=SEED),
                      num_nodes=1 << scale)
        graphs[scale] = g
        print(f"[8] graph RMAT {scale}: {g.num_nodes} nodes, "
              f"{g.num_edges_undirected} undirected edges, "
              f"{time.perf_counter() - t0:.2f} s")

    # [8] main path, counters from 0
    kc.reset_launches()
    ranks = {}
    for scale, k, golden in KCLIQUE_RUNS:
        g = graphs[scale]
        t0 = time.perf_counter()
        rank, degen = degeneracy.degeneracy_ordering_rank(g)
        peel_s = time.perf_counter() - t0
        ranks[scale] = rank
        before = dict(kc.LAUNCHES)
        t0 = time.perf_counter()
        count = kc.kclique_count(g, k, device="cuda", rank=rank)
        count_s = time.perf_counter() - t0
        used = {n: kc.LAUNCHES[n] - before[n] for n in before}
        print(f"[8] RMAT {scale} k={k}: count {count}, golden {golden}; "
              f"degeneracy {degen}; peel {peel_s:.3f} s; count {count_s:.4f} s"
              f" (synchronised); {count / count_s:.1f} cliques/s; "
              f"launches {used}")
        check(count == golden, f"RMAT {scale} k={k}: {count} != {golden}")
    launches = {n: kc.LAUNCHES[n] for n in KCLIQUE_PATH}
    print(f"[8] k-clique main path launches: {launches}")
    check(all(n > 0 for n in launches.values()),
          f"a k-clique kernel of the path never launched: {launches}")
    check(launches["kclique_dense_count"] == K5_MAIN_LAUNCHES,
          f"K5 launched {launches['kclique_dense_count']} times, not "
          f"{K5_MAIN_LAUNCHES}")
    # K5 over the warm k = 5 call, under torch.profiler
    scale, k, golden = KCLIQUE_RUNS[0]
    count, host_s, per, busy = profile_window(
        lambda: kc.kclique_count(graphs[scale], k, device="cuda",
                                 rank=ranks[scale]))
    check(count == golden, f"the profiled RMAT {scale} call gave {count}")
    k5_whole = window_lines(
        f"[8] warm RMAT {scale} k={k} call under torch.profiler:", host_s,
        per, busy, {"K5": K5_KERNELS, "K4": ("local_adj_kernel",)})["K5"]
    check(k5_whole[0] > 0, "torch.profiler traced no K5 time")
    # K6 over the warm k >= 6 calls, under torch.profiler
    for scale, k, golden in KCLIQUE_RUNS[1:]:
        count, host_s, per, busy = profile_window(
            lambda g=graphs[scale], k=k, r=ranks[scale]: kc.kclique_count(
                g, k, device="cuda", rank=r))
        check(count == golden, f"the profiled RMAT {scale} call gave {count}")
        window_lines(f"[8] warm RMAT {scale} k={k} call under torch.profiler:",
                     host_s, per, busy,
                     {"K6": K6_KERNELS, "K4": ("local_adj_kernel",)})
    plans = {}
    for scale, k, golden in KCLIQUE_RUNS:
        t0 = time.perf_counter()
        pg, chunks = kc.plan_chunks(graphs[scale], k, device="cuda",
                                    rank=ranks[scale])
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        plans[scale] = (k, pg, chunks)
        print(f"    RMAT {scale} k={k}: host plan (orient, pad, tiers, copies "
              f"to the card) {plan_s:.4f} s; D_pad {pg.d_pad}, tiers (W: "
              f"chunks / real roots) {tiers(chunks, pg.v_pad)}")

    # [9] the ADG ordering gives the same count
    head, k_head, golden = KCLIQUE_RUNS[0]
    t0 = time.perf_counter()
    adg = degeneracy.adg_ordering_rank(graphs[head], 0.1)
    adg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    count = kc.kclique_count(graphs[head], k_head, device="cuda", rank=adg)
    count_s = time.perf_counter() - t0
    pg, chunks = kc.plan_chunks(graphs[head], k_head, device="cuda", rank=adg)
    print(f"[9] RMAT {head} k={k_head} ADG eps 0.1: count {count}; ADG "
          f"{adg_s:.3f} s; count {count_s:.4f} s; max out-degree "
          f"{int(pg.deg.max())}, D_pad {pg.d_pad}; tiers "
          f"{tiers(chunks, pg.v_pad)}")
    check(count == golden, f"ADG-ordered RMAT {head}: {count} != {golden}")
    del pg, chunks

    # [10] each kernel against its plain version, exactly
    rate = sm_rate(POPC_PER_CLOCK_PER_SM)
    print(f"[10] popcount rate {rate:.4e} word ops/s "
          f"({POPC_PER_CLOCK_PER_SM}/clock/SM x "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs x"
          f" {smi('clocks.max.sm')})")
    # the dense run (k=5): its operations are the AND+popcount words the
    # sums need (the plain version counts them); the earlier count, a whole
    # row of WW words each (i, j, m), is printed beside them
    _, pg, chunks = plans[head]
    adjs = [kc.build_local_adj(pg.nbr, c, w_words=ww) for c, ww in chunks]
    k3 = [int(kc.kclique_dense_count(a, k=3)) for a, _ in adjs]
    k4 = [int(kc.kclique_dense_count(a, k=4)) for a, _ in adjs]
    k5_ops = []
    for a, _ in adjs:
        stats = {}
        kc.kclique_dense_count_plain(a, k=5, stats=stats)
        k5_ops.append(stats["word_ops"])
    rows_ops = sum(n4 * a.shape[2] for (a, _), n4 in zip(adjs, k4))
    print(f"[10] kclique_dense_count's operations at k=5: {sum(k5_ops)} "
          f"words the sums need (bound {sum(k5_ops) / rate * 1e3:.4f} ms); "
          f"k=4 count x WW, a whole row each (i, j, m): {rows_ops} (bound "
          f"{rows_ops / rate * 1e3:.4f} ms)")
    calls = {
        # nbr bound now: the loop over the K6 runs below rebinds pg
        "build_local_adj": [
            (f"RMAT {head} W={32 * ww} C={c.numel()}",
             lambda c=c, ww=ww, nbr=pg.nbr: kc.build_local_adj(
                 nbr, c, w_words=ww),
             lambda c=c, ww=ww, nbr=pg.nbr: kc.build_local_adj_plain(
                 nbr, c, w_words=ww),
             local_adj_bytes(pg, c, ww))
            for c, ww in chunks],
        "kclique_dense_count": [
            (f"RMAT {head} k=5 W={a.shape[1]} C={a.shape[0]}",
             lambda a=a: kc.kclique_dense_count(a, k=5),
             lambda a=a: kc.kclique_dense_count_plain(a, k=5),
             a.numel() * 4 + 8, ops)
            for (a, _), ops in zip(adjs, k5_ops)],
    }
    print(f"    RMAT {head} per chunk: k=3 counts {k3}, k=4 counts {k4}")
    stack_calls = []
    k_132 = np.stack(np.nonzero(np.triu(np.ones((132, 132), bool), 1)), 1)
    g132 = build_csr(k_132.astype(np.int64))
    pg132, chunks132 = kc.plan_chunks(g132, 6, device="cuda")
    runs = [(f"RMAT {s}", plans[s]) for s, _, _ in KCLIQUE_RUNS[1:]]
    runs.append(("K_132", (6, pg132, [(c, ww) for c, ww in chunks132
                                      if ww == 8])))
    for label, (k, pg, chunks) in runs:
        for c, ww in chunks:
            adj, s0 = kc.build_local_adj(pg.nbr, c, w_words=ww)
            stats = {}
            kc.kc_stack_count_plain(adj, s0, k=k, stats=stats)
            stack_calls.append((
                f"{label} k={k} W={32 * ww} C={c.numel()}",
                lambda adj=adj, s0=s0, k=k: kc.kc_stack_count(adj, s0, k=k),
                lambda adj=adj, s0=s0, k=k: kc.kc_stack_count_plain(adj, s0,
                                                                    k=k),
                (adj.numel() + s0.numel()) * 4 + 8, stats["word_ops"]))
    n_main = sum(len(plans[s][2]) for s, _, _ in KCLIQUE_RUNS[1:])
    calls["kc_stack_count"] = stack_calls[:n_main]
    # each main-path chunk's K6 time as the call meets it (CUDA events, one
    # warm-up call, the median of KERNEL_REPS, L2 not flushed) and its share
    chunk_ms = []
    for label, kernel, *_ in stack_calls[:n_main]:
        kernel()
        chunk_ms.append((label, statistics.median(
            event_ms(kernel) for _ in range(KERNEL_REPS))))
    whole = sum(ms for _, ms in chunk_ms)
    print("[10] kc_stack_count by main-path chunk (CUDA events): " + "; ".join(
        f"{label} {ms:.4f} ms ({ms / whole:.3f})" for label, ms in chunk_ms)
        + f"; {whole:.4f} ms in all")
    for name, kcalls in calls.items():
        err, k_ms, p_ms, bound_ms, by = compare(timing, kcalls, ops_rate=rate,
                                                plain_reps=1)
        whole = (f"; over the warm call (phase 8) {k5_whole[0]:.4f} ms of "
                 f"device time, {k5_whole[1]} launches traced"
                 if name == "kclique_dense_count" else "")
        print(f"[10] {name}: {len(kcalls)} launches, max_abs_err {err}, "
              f"kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
              f"plain {p_ms:.4f} ms{whole}")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        lib_ms = (dense_library(timing, kc, adjs, k4)
                  if name == "kclique_dense_count" else None)
        report.append(kernel_entry(name, launches[name], err, k_ms, p_ms,
                                   bound_ms, by, library_ms=lib_ms))
    del adjs
    # K4's held chunks by device time: each event pair above also spans the
    # wrapper's host time wherever the host lags the L2 flush
    k4_jobs = [c[1] for c in calls["build_local_adj"]]
    _, _, per, _ = profile_window(lambda: [f() for _ in range(10)
                                           for f in k4_jobs])
    k4_us, k4_n = per.get("local_adj_kernel", (0.0, 0))
    print(f"[10] build_local_adj on its {len(k4_jobs)} held chunks by device "
          f"time (torch.profiler, 10 warm passes): {k4_us / 1e4:.4f} ms a "
          f"pass, {k4_n} launches traced")
    check(k4_us > 0, "torch.profiler traced no K4 time on the held chunks")
    # K4 on the sharded count's first chunk (phase 53's call) at its one
    # global W, which pads every chunk
    from gms_tpu_torch.graphs.tiles import PaddedGraph
    from gms_tpu_torch.preprocessing import orient
    spg = PaddedGraph.from_csr(orient.orient(graphs[head], ranks[head]),
                               device="cuda", lane=32)
    sww = spg.d_pad // 32
    sroots = torch.nonzero(spg.deg >= k_head - 1).reshape(-1)[:256].to(
        torch.int32)
    err, k_ms, p_ms, bound_ms, by = compare(timing, [(
        f"RMAT {head} sharded chunk 1 W={32 * sww} C={sroots.numel()}",
        lambda: kc.build_local_adj(spg.nbr, sroots, w_words=sww),
        lambda: kc.build_local_adj_plain(spg.nbr, sroots, w_words=sww),
        local_adj_bytes(spg, sroots, sww))], plain_reps=1)
    print(f"[10] build_local_adj on the sharded call's first chunk: "
          f"max_abs_err {err}, kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({by}), plain {p_ms:.4f} ms | {card_line()}")
    check(err == 0, f"build_local_adj disagrees on the sharded chunk by {err}")
    del spg, sroots
    err, k_ms, p_ms, bound_ms, by = compare(timing, stack_calls[n_main:],
                                            ops_rate=rate, plain_reps=1)
    print(f"[10] kc_stack_count K_132 W=256 chunk: max_abs_err {err}, kernel "
          f"{k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
          f"{p_ms:.4f} ms")
    check(err == 0, f"kc_stack_count disagrees on K_132 by {err}")
    del calls, stack_calls, plans

    # [11] small graphs against the oracle
    small = build_csr(generate_rmat_el(10, DEGREE, seed=SEED),
                      num_nodes=1 << 10)
    for k in range(3, 8):
        want = kc.kclique_count_oracle(small, k)
        got = kc.kclique_count(small, k, device="cuda")
        check(got == want, f"RMAT 10 k={k}: {got} != oracle {want}")
    k7 = build_csr(np.stack(np.nonzero(np.triu(np.ones((7, 7), bool), 1)),
                            1).astype(np.int64))
    for k in range(1, 9):
        got = kc.kclique_count(k7, k, device="cuda")
        check(got == math.comb(7, k), f"K_7 k={k}: {got} != {math.comb(7, k)}")
    got = kc.kclique_count(g132, 6, device="cuda")
    check(got == math.comb(132, 6), f"K_132 k=6: {got} != C(132, 6)")
    print(f"[11] RMAT 10 k=3..7 equal the oracle; K_7 k=1..8 and K_132 k=6 "
          f"({got}) equal the binomials")


def bk_tiers(plan) -> str:
    """'W: jobs / real roots, IN lo-hi' of each tier width of a BK plan."""
    out = {}
    pad = plan.padded.v_pad
    for chunk, ww, in_w in plan.jobs:
        j, r, lo, hi = out.get(32 * ww, (0, 0, in_w, in_w))
        out[32 * ww] = (j + 1, r + int((chunk != pad).sum()), min(lo, in_w),
                        max(hi, in_w))
    return " · ".join(f"{w}: {j} / {r}, IN {lo}-{hi}"
                      for w, (j, r, lo, hi) in sorted(out.items()))


def cover_bytes(plan, chunk, ww, in_w) -> int:
    """K8's bytes: each distinct DAG row it reads (the roots' and their
    lower neighbours'), up to and including its first SENTINEL, the roots,
    their CSR entries, and M and wvalid written."""
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    wl = bk.gather_wlists(plan.lo_indptr, plan.lo_cols, chunk, in_width=in_w)
    v_pad = plan.padded.v_pad
    rows = torch.cat([chunk.long().clamp(0, v_pad - 1),
                      wl[wl != bk._SENT].long()])
    words = data_words(plan.padded.deg, torch.unique(rows),
                       plan.padded.d_pad)
    c = chunk.numel()
    return ((words + 3 * c + int((wl != bk._SENT).sum())
             + c * in_w * ww) * 4 + c * in_w)


def decode_bytes(plan, chunk, out) -> int:
    """K10's bytes: the rows read, gid and members written, and each distinct
    root row up to its first SENTINEL (at most W slots)."""
    ww = out.shape[1] - 1
    gid = chunk[out[:, ww].long().clamp(0, chunk.numel() - 1)]
    words = data_words(plan.padded.deg, torch.unique(gid), 32 * ww)
    return (out.numel() + out.shape[0] * (1 + 32 * ww) + words) * 4


def sorted_rows(out):
    """The rows of out in lexicographic order, sorted on its device: one
    stable sort per column, the last column first."""
    idx = torch.arange(out.shape[0], device=out.device)
    for c in reversed(range(out.shape[1])):
        idx = idx[torch.sort(out[idx, c], stable=True).indices]
    return out[idx]


def rows_err(got, want) -> int:
    """max_abs_err of two sets of rows (2^31 if their shapes differ)."""
    a, b = sorted_rows(got), sorted_rows(want)
    if a.shape != b.shape:
        return 1 << 31
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def own_ops(stats, rates) -> tuple:
    """(popcounts, bitwise operations, ms) a search needs at least, from its
    plain version's stats: where the plain version counts them (K9, K36),
    the pivot's words by the cheaper of two ways a node (each member of
    cand | fini on cand's nonzero words, or each member of cand's row added
    to every score), each child's 2 * WW words and K9's running cover; else (K12) the plain tree's own counts. The ms is
    the larger of the popcounts over rates[0] and the bitwise operations
    (the pivot's ANDs included) over rates[1]."""
    if "popc_need" in stats:
        popc = stats["popc_need"]
        bit = popc + stats["child_ops"] + stats.get("cover_ops", 0)
    else:
        popc, bit = stats["popc_ops"], stats["bit_ops"]
    return popc, bit, max(popc / rates[0], bit / rates[1]) * 1e3


def search_compare(timing, label, kernel, plain, nbytes, rates):
    """Holds a search kernel (K9, K12) against one plain run on a job: its
    count and its emitted rows as sorted sets; prints a line. kernel(emit)
    returns the count, or (count, rows) with emit; plain(emit, stats) the
    same, and with stats it counts the tree's word operations by type,
    whose bound is the larger of the popcounts over `rates[0]` and the
    bitwise operations over `rates[1]` (different units; own_ops; the plain
    tree's whole count, |cand | fini| * WW popcounts a node and the leaf
    test's |R| + 1 rows, is printed beside it). Returns (max_abs_err,
    kernel ms, emit ms, plain ms, bytes bound ms, operations bound ms,
    popcounts, bitwise operations, the plain tree's operations ms)."""
    stats = {}
    want, want_out = plain(True, stats)
    got = kernel(False)
    n, out = kernel(True)
    diff = max(max_abs_err(got, want), max_abs_err(n, want),
               rows_err(out, want_out))
    kt = timing.ms(lambda: kernel(False), KERNEL_REPS)
    et = timing.ms(lambda: kernel(True), KERNEL_REPS)
    pt = timing.ms(lambda: plain(False, None), 1)
    bt = nbytes / HBM_BYTES_PER_S * 1e3
    popc, bit, ot = own_ops(stats, rates)
    tree = max(stats["popc_ops"] / rates[0],
               stats["bit_ops"] / rates[1]) * 1e3
    print(f"    {label}: count {want.tolist()}, max_abs_err {diff}, kernel "
          f"{kt:.4f} ms (emit {et:.4f} ms), bound {max(bt, ot):.4f} ms "
          f"({nbytes} bytes -> {bt:.4f} ms; {popc} popcounts, {bit} bitwise "
          f"ops -> {ot:.4f} ms; the plain tree's {stats['popc_ops']} and "
          f"{stats['bit_ops']} -> {tree:.4f} ms), plain {pt:.4f} ms")
    return diff, kt, et, pt, bt, ot, popc, bit, tree


def search_summary(results):
    """search_compare's results summed over jobs: (max_abs_err, kernel ms,
    emit ms, plain ms, popcounts, bitwise operations, bound ms, bound_by,
    the plain tree's bound ms); each job's bound is the larger of its byte
    and operation times."""
    err = max(r[0] for r in results)
    k_ms, e_ms, p_ms, popc, bit = (sum(r[i] for r in results)
                                   for i in (1, 2, 3, 6, 7))
    bound = sum(max(r[4], r[5]) for r in results)
    tree = sum(max(r[4], r[8]) for r in results)
    by = ("operations" if sum(r[5] for r in results) >
          sum(r[4] for r in results) else "bytes")
    return err, k_ms, e_ms, p_ms, popc, bit, bound, by, tree


def bk_compare(timing, label, univ, rates):
    """search_compare for K9 on a job's universe (adj, S0, live0, M,
    wvalid)."""
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    return search_compare(
        timing, label, lambda emit: bk.bk_stack_machine(*univ, emit=emit),
        lambda emit, stats: bk.bk_stack_machine_plain(*univ, emit=emit,
                                                      stats=stats),
        bk_stack_bytes(*univ), rates)


def bk_stack_bytes(adj, s0, live0, m, wvalid) -> int:
    """K9's bytes in count mode: live0, the live roots' S0 and wvalid, the
    adj rows of each slot in their S0 (every node's cand and fini lie in
    S0: padded slots and dead roots' rows stay unread), the M rows that
    wvalid marks for them (the cover; the padding past each root's
    in-degree stays unread), and the int64 total written."""
    from gms_tpu_torch.algorithms.triangle_count import popcount32
    ww = s0.shape[1]
    live = live0.bool()
    n_live = int(live.sum())
    slots = int(popcount32(s0[live]).sum())
    covers = int(wvalid[live].sum())
    return (live0.numel() + 8 + n_live * wvalid.shape[1]
            + 4 * ww * (n_live + slots + covers))


def bk_jobs(plan):
    """[(label, chunk, ww, in_w, cover kwargs)] of a BK plan's jobs."""
    return [(f"W={32 * ww} IN={in_w} C={chunk.numel()}", chunk, ww, in_w,
             dict(in_width=in_w, w_words=ww)) for chunk, ww, in_w in plan.jobs]


def bk_calls(bk, plan, label, chunk, ww, in_w, cover, calls):
    """Appends a job's K7 and K8 calls to `calls`; returns its K9 universe
    (adj symmetrized, S0, live0, M, wvalid) and its K4 adj."""
    from gms_tpu_torch.algorithms import k_clique as kc
    nbr = plan.padded.nbr
    adj, s0 = kc.build_local_adj(nbr, chunk, w_words=ww)
    calls["symmetrize_bits"].append((
        label, lambda: bk.symmetrize_bits(adj),
        lambda: bk.symmetrize_bits_plain(adj), adj.numel() * 8))
    calls["hub_cover_bits"].append((
        label, lambda: bk.hub_cover_bits(nbr, plan.lo_indptr, plan.lo_cols,
                                         chunk, **cover),
        lambda: bk.hub_cover_bits_plain(nbr, plan.lo_indptr, plan.lo_cols,
                                        chunk, **cover),
        cover_bytes(plan, chunk, ww, in_w)))
    m, wv = bk.hub_cover_bits(nbr, plan.lo_indptr, plan.lo_cols, chunk,
                              **cover)
    return (bk.symmetrize_bits(adj), s0, chunk != nbr.shape[0], m, wv), adj


def bk_phases(timing, report) -> None:
    """Phases 12-16: the Bron-Kerbosch path (see the module docstring)."""
    from gms_tpu_torch.bench.profiling import (BK_GROUPS, profile_window,
                                               window_lines)
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.preprocessing import degeneracy

    def launches():
        return dict(bk.LAUNCHES,
                    build_local_adj=kc.LAUNCHES["build_local_adj"])

    t0 = time.perf_counter()
    g = build_csr(generate_rmat_el(BK_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << BK_SCALE)
    print(f"[12] graph RMAT {BK_SCALE}: {g.num_nodes} nodes, "
          f"{g.num_edges_undirected} undirected edges, "
          f"{int((g.degrees == 0).sum())} isolated, "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rank, degen = degeneracy.degeneracy_ordering_rank(g)
    peel_s = time.perf_counter() - t0

    # [12] main path, counters from 0 (K4 is k_clique's build_local_adj)
    bk.reset_launches()
    kc.reset_launches()
    t0 = time.perf_counter()
    count = bk.bron_kerbosch(g, device="cuda", rank=rank)
    call_s = time.perf_counter() - t0
    main = launches()
    roots = np.arange(g.num_nodes, dtype=np.int32)
    t0 = time.perf_counter()
    plan = bk.BKPlan(g, rank, roots, device="cuda")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    print(f"[12] RMAT {BK_SCALE} maximal cliques: count {count}, golden "
          f"{BK_GOLDEN}; degeneracy {degen}; peel {peel_s:.3f} s; call "
          f"{call_s:.4f} s (synchronised; host plan alone {plan_s:.4f} s: "
          f"orient, pad, lower CSR, sub-chunks, copies); "
          f"{count / call_s:.1f} cliques/s; launches {main}")
    print(f"    D_pad {plan.padded.d_pad}, max in-degree "
          f"{int(plan.indeg.max())}; tiers (W: jobs / real roots, IN) "
          f"{bk_tiers(plan)}")
    check(count == BK_GOLDEN, f"RMAT {BK_SCALE} BK: {count} != {BK_GOLDEN}")
    count_path = ("build_local_adj", "symmetrize_bits", "hub_cover_bits",
                  "bk_stack_machine")
    check(all(main[n] > 0 for n in count_path),
          f"a kernel of the BK count path never launched: {main}")
    again, host_s, per, busy = profile_window(
        lambda: bk.bron_kerbosch(g, device="cuda", rank=rank))
    check(again == BK_GOLDEN, f"the profiled fused call gave {again}")
    window_lines("[12] warm fused call under torch.profiler:", host_s, per,
                 busy, BK_GROUPS)
    del plan

    # [13] the ADG ordering gives the same count
    t0 = time.perf_counter()
    adg = degeneracy.adg_ordering_rank(g, 0.1)
    adg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    count = bk.bron_kerbosch(g, device="cuda", rank=adg)
    call_s = time.perf_counter() - t0
    plan = bk.BKPlan(g, adg, roots, device="cuda")
    print(f"[13] RMAT {BK_SCALE} ADG eps 0.1: count {count}; ADG {adg_s:.3f} "
          f"s; call {call_s:.4f} s; {count / call_s:.1f} cliques/s; max "
          f"out-degree {int(plan.dag_deg.max())}; tiers {bk_tiers(plan)}")
    check(count == BK_GOLDEN, f"ADG-ordered RMAT {BK_SCALE}: {count} != "
                              f"{BK_GOLDEN}")
    del plan

    # [14] enumerate mode, counters from 0 just before its sink= run
    small = build_csr(generate_rmat_el(BK_SMALL, DEGREE, seed=SEED),
                      num_nodes=1 << BK_SMALL)
    srank, _ = degeneracy.degeneracy_ordering_rank(small)
    want = bk.bron_kerbosch(small, device="cuda", rank=srank)
    chunks = []
    bk.reset_launches()
    kc.reset_launches()
    t0 = time.perf_counter()
    n_emit, none = bk.bron_kerbosch(small, device="cuda", rank=srank,
                                    collect=True,
                                    sink=lambda g_, m_: chunks.append((g_, m_)))
    emit_s = time.perf_counter() - t0
    enum = launches()
    rows = sum(len(c[0]) for c in chunks)
    check(none is None and n_emit == want == rows,
          f"RMAT {BK_SMALL} sink: {rows} rows, count {n_emit} != {want}")
    enum_path = ("build_local_adj", "symmetrize_bits", "hub_cover_bits",
                 "bk_stack_machine", "decode_clique_members")
    check(all(enum[n] > 0 for n in enum_path),
          f"a kernel of the BK enumerate path never launched: {enum}")
    nbrs = [set(small.out_neigh(v).tolist()) for v in range(small.num_nodes)]
    ends = np.cumsum([len(c[0]) for c in chunks])
    sample = np.random.default_rng(SEED).choice(rows, BK_SAMPLE,
                                                replace=False)
    for l in sample:
        j = int(np.searchsorted(ends, l, side="right"))
        gid, members = chunks[j]
        r = l - (ends[j - 1] if j else 0)
        clique = [int(gid[r]), *members[r][members[r] >= 0].tolist()]
        common = set.intersection(*(nbrs[v] for v in clique))
        check(all(b in nbrs[a] for i, a in enumerate(clique)
                  for b in clique[i + 1:]) and not common - set(clique),
              f"RMAT {BK_SMALL} row {l} is not a maximal clique: {clique}")
    tiny = build_csr(generate_rmat_el(8, DEGREE, seed=SEED), num_nodes=256)
    oracle = set(bk.bron_kerbosch_simple(tiny))
    n_tiny, cl = bk.bron_kerbosch(tiny, device="cuda", collect=True)
    check(n_tiny == len(oracle) and set(cl) == oracle,
          f"RMAT 8 collect: {n_tiny} cliques, oracle {len(oracle)}")
    print(f"[14] RMAT {BK_SMALL}: {n_emit} maximal cliques streamed to the "
          f"sink in {len(chunks)} jobs, {emit_s:.4f} s, launches {enum} "
          f"(bk_stack_machine: a count and an emit pass a job with rows); "
          f"{BK_SAMPLE} sampled rows are maximal cliques; RMAT 8 collect "
          f"equals bron_kerbosch_simple ({n_tiny})")

    # [15] the RMAT 14 call, job by job; K7 and K8 against their plain
    # versions on every job, K9 on the jobs with IN >= 2048 and on one W=128
    # job
    rates = (sm_rate(POPC_PER_CLOCK_PER_SM), sm_rate(BITWISE_PER_CLOCK_PER_SM))
    plan = bk.BKPlan(g, rank, roots, device="cuda")
    nbr = plan.padded.nbr
    calls = {"symmetrize_bits": [], "hub_cover_bits": []}
    k4_ms = k9_ms = 0.0
    k4_bytes = k9_bytes = total = 0
    jobs = []
    whole = {}
    for label, chunk, ww, in_w, cover in bk_jobs(plan):
        univ, adj = bk_calls(bk, plan, label, chunk, ww, in_w, cover, calls)
        n = int(bk.bk_stack_machine(*univ))
        total += n
        st = {}
        check(int(bk.bk_stack_machine(*univ, stats=st)) == n,
              f"{label}: the stats= run's count differs")
        add_split(whole, st)
        if ww == 4 and in_w == 1024:
            print(f"    W=128 IN=1024 job ({label}), stats=: "
                  f"{walk_split(st)}")
        k4_ms += timing.ms(lambda c=chunk, w=ww: (
            kc.build_local_adj(nbr, c, w_words=w)), 3)
        t9 = timing.ms(lambda u=univ: bk.bk_stack_machine(*u), 3)
        k9_ms += t9
        k4_bytes += local_adj_bytes(plan.padded, chunk, ww)
        k9_bytes += bk_stack_bytes(*univ)
        jobs.append((f"RMAT {BK_SCALE} {label}", ww, in_w, n, univ))
        if t9 > 10:
            print(f"    W={32 * ww} IN={in_w} real roots "
                  f"{int((chunk != nbr.shape[0]).sum())}: {n} cliques, "
                  f"bk_stack_machine {t9:.4f} ms")
    check(total == BK_GOLDEN, f"RMAT {BK_SCALE} job by job: {total}")
    print(f"[15] bk_stack_machine over the {len(jobs)} jobs, stats=: "
          f"{walk_split(whole)}")
    entries = {}
    for name, kcalls in calls.items():
        entries[name] = compare(timing, kcalls, plain_reps=1)
        err, k_ms, p_ms, bound_ms, by = entries[name]
        print(f"[15] {name}: {len(kcalls)} jobs, max_abs_err {err}, kernel "
              f"{k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
              f"{p_ms:.4f} ms")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
    w128 = [j for j in jobs if j[1] == 4 and 0 < j[3] <= BK_PLAIN_CLIQUES]
    check(bool(w128), f"RMAT {BK_SCALE} has no W=128 job the plain K9 takes")
    held = [j for j in jobs if j[2] >= 2048] + [max(w128, key=lambda j: j[3])]
    stack = [bk_compare(timing, label, univ, rates)
             for label, _, _, _, univ in held]
    print(f"[15] RMAT {BK_SCALE}, {len(jobs)} jobs, kernel ms summed "
          f"against bytes over 3.35 TB/s: build_local_adj {k4_ms:.4f} ms "
          f"(median of 3) vs {k4_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
          + "; ".join(f"{n} {entries[n][1]:.4f} ms vs {entries[n][3]:.4f} ms"
                      for n in calls)
          + f"; bk_stack_machine {k9_ms:.4f} ms (median of 3) vs "
          f"{k9_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; bk_stack_machine held "
          f"against its plain version on {len(held)} jobs (IN >= 2048, and "
          f"the W=128 job with the most cliques up to {BK_PLAIN_CLIQUES}), "
          f"max_abs_err {max(r[0] for r in stack)}")
    check(all(r[0] == 0 for r in stack),
          "bk_stack_machine disagrees with its plain version at RMAT "
          f"{BK_SCALE}")
    del plan, g, jobs, calls, held

    # [16] each kernel against its plain version, exactly, on RMAT 12
    plan = bk.BKPlan(small, srank, np.arange(small.num_nodes,
                                               dtype=np.int32), device="cuda")
    nbr = plan.padded.nbr
    print(f"[16] RMAT {BK_SMALL} plan: tiers {bk_tiers(plan)}")
    calls = {"symmetrize_bits": [], "hub_cover_bits": []}
    decode = []
    for label, chunk, ww, in_w, cover in bk_jobs(plan):
        univ, _ = bk_calls(bk, plan, label, chunk, ww, in_w, cover, calls)
        stack.append(bk_compare(timing, f"RMAT {BK_SMALL} {label}", univ,
                                   rates))
        _, out = bk.bk_stack_machine(*univ, emit=True)
        if not out.shape[0]:  # bron_kerbosch decodes only rows it has
            continue
        decode.append((
            f"{label} L={out.shape[0]}",
            lambda c=chunk, o=out: bk.decode_clique_members(nbr, c, o),
            lambda c=chunk, o=out: bk.decode_clique_members_plain(nbr, c, o),
            decode_bytes(plan, chunk, out)))
    # K7, K8: the main path's times (RMAT 14) and the larger error of both
    for name, kcalls in calls.items():
        err, k_ms, p_ms, bound_ms, by = compare(timing, kcalls)
        print(f"[16] {name}: {len(kcalls)} launches, max_abs_err {err}, "
              f"kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
              f"plain {p_ms:.4f} ms")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        main_err, *rest = entries[name]
        report.append(kernel_entry(name, main[name], max(err, main_err),
                                   *rest))
    # K9: summed over every job it was held against its plain version on
    err, k_ms, e_ms, p_ms, popc, bit, bound, by, tree = search_summary(stack)
    print(f"[16] bk_stack_machine: {len(stack)} jobs held against the plain "
          f"version ({len(stack) - len(plan.jobs)} of RMAT {BK_SCALE}, "
          f"every job of RMAT {BK_SMALL}), max_abs_err {err} (count and "
          f"emitted rows), kernel {k_ms:.4f} ms (emit {e_ms:.4f} ms), bound "
          f"{bound:.4f} ms ({by}; {popc} popcounts, {bit} bitwise ops; the "
          f"plain tree's count {tree:.4f} ms), plain {p_ms:.4f} ms")
    check(err == 0, f"bk_stack_machine disagrees with its plain version by "
                    f"{err}")
    report.append(kernel_entry("bk_stack_machine", main["bk_stack_machine"],
                               err, k_ms, p_ms, bound, by))
    # K10: its path is enumerate mode's (RMAT 12)
    err, k_ms, p_ms, bound_ms, by = compare(timing, decode)
    print(f"[16] decode_clique_members: {len(decode)} launches, max_abs_err "
          f"{err}, kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
          f"plain {p_ms:.4f} ms")
    check(err == 0, f"decode_clique_members disagrees by {err}")
    report.append(kernel_entry("decode_clique_members",
                               enum["decode_clique_members"], err, k_ms,
                               p_ms, bound_ms, by))


def star_jobs_line(jobs, pad_id) -> str:
    """'W: slots / real roots' of each job of a k-clique-star plan."""
    return " · ".join(f"{32 * ww}: {c.numel()} / {int((c != pad_id).sum())}"
                      for c, ww in jobs)


def univ_bytes(pg, chunk, ww) -> int:
    """K11's bytes: each distinct row it reads (the roots' and their
    neighbours'), up to and including its first SENTINEL, the roots, the
    ranks of the roots and their slots, and the two matrices and two sets
    written."""
    from gms_tpu_torch.graphs.tiles import SENTINEL
    nbr, v_pad = pg.nbr, pg.v_pad
    roots = chunk.long().clamp(0, v_pad - 1)
    r_nbr = nbr[roots, :min(32 * ww, nbr.shape[1])]
    slots = r_nbr[r_nbr != SENTINEL].long()
    words = data_words(pg.deg, torch.unique(torch.cat([roots, slots])),
                       nbr.shape[1])
    ranks = torch.unique(torch.cat([chunk.long().clamp(0, v_pad), slots]))
    c = chunk.numel()
    return (words + c + ranks.numel() + 2 * c * 32 * ww * ww
            + 2 * c * ww) * 4


def star_stack_bytes(adj_full, adj_dag, s0, i0, live0, k) -> int:
    """K12's bytes in count mode: live0, the live roots' S0 and I0, the
    adj_full and adj_dag rows of each slot in S0 of the roots it searches
    (|S0| >= k-1; every node's S lies in S0, so no other row is read), and
    the two int64 totals written."""
    from gms_tpu_torch.algorithms.triangle_count import popcount32
    ww = s0.shape[1]
    size = popcount32(s0).sum(1)
    searched = live0 & (size >= k - 1)
    return (live0.numel() + 16 + 4 * 2 * ww * (int(live0.sum())
                                               + int(size[searched].sum())))


def star_decode_bytes(pg, chunk, out) -> int:
    """K13's bytes: the rows read, gid and both id blocks written, and each
    distinct root row up to its first SENTINEL (at most W slots)."""
    ww = (out.shape[1] - 1) // 2
    gid = chunk[out[:, 2 * ww].long().clamp(0, chunk.numel() - 1)]
    words = data_words(pg.deg, torch.unique(gid), 32 * ww)
    return (out.numel() + out.shape[0] * (1 + 64 * ww) + words) * 4


def star_phases(timing, report) -> None:
    """Phases 17-22: the k-clique-star path (see the module docstring)."""
    from gms_tpu_torch.bench.profiling import (STAR_GROUPS, profile_window,
                                               window_lines)
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.algorithms import k_clique_star as ks
    from gms_tpu_torch.algorithms.triangle_count import popcount32
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.preprocessing import degeneracy

    k = STAR_K
    t0 = time.perf_counter()
    g = build_csr(generate_rmat_el(STAR_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << STAR_SCALE)
    print(f"[17] graph RMAT {STAR_SCALE}: {g.num_nodes} nodes, "
          f"{g.num_edges_undirected} undirected edges, max degree "
          f"{g.max_degree}, {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rank, degen = degeneracy.degeneracy_ordering_rank(g)
    peel_s = time.perf_counter() - t0

    # [17] main path: a first call (it loads the star kernels' modules and
    # sets their launch attributes), then the counters from 0 and the timed
    # call
    t0 = time.perf_counter()
    ks.kclique_star_list(g, k, device="cuda", rank=rank, mode="count")
    cold_s = time.perf_counter() - t0
    ks.reset_launches()
    t0 = time.perf_counter()
    got = ks.kclique_star_list(g, k, device="cuda", rank=rank, mode="count")
    call_s = time.perf_counter() - t0
    main = dict(ks.LAUNCHES)
    t0 = time.perf_counter()
    pg, rank_pad, jobs = ks.plan_star_jobs(g, k, device="cuda", rank=rank)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    print(f"[17] RMAT {STAR_SCALE} k={k} stars: (cliques, star total) {got}, "
          f"golden {STAR_GOLDEN}; degeneracy {degen}; peel {peel_s:.3f} s; "
          f"call {call_s:.4f} s (synchronised, warm; the first call "
          f"{cold_s:.4f} s; host plan alone {plan_s:.4f} s: pad, rank_pad, "
          f"tiers, sub-chunks, copies); {got[0] / call_s:.1f} cliques/s; "
          f"launches {main}")
    print(f"    D_pad {pg.d_pad}; {len(jobs)} jobs (W: slots / real roots) "
          f"{star_jobs_line(jobs, pg.v_pad)}")
    check(got == STAR_GOLDEN, f"RMAT {STAR_SCALE} k={k} stars: {got} != "
                              f"{STAR_GOLDEN}")
    check(main["build_local_univ"] > 0 and main["star_stack"] > 0,
          f"a kernel of the star count path never launched: {main}")

    # [18] the ADG ordering gives the same numbers
    t0 = time.perf_counter()
    adg = degeneracy.adg_ordering_rank(g, 0.1)
    adg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = ks.kclique_star_list(g, k, device="cuda", rank=adg, mode="count")
    call_s = time.perf_counter() - t0
    print(f"[18] RMAT {STAR_SCALE} ADG eps 0.1: {got}; ADG {adg_s:.3f} s; "
          f"call {call_s:.4f} s; {got[0] / call_s:.1f} cliques/s")
    check(got == STAR_GOLDEN, f"ADG-ordered RMAT {STAR_SCALE} stars: {got}")

    # [19] star_total(k) = (k+1) · #K_{k+1}
    for kk in (3, 4):
        n, total = ks.kclique_star_list(g, kk, device="cuda", rank=rank,
                                        mode="count")
        nk = kc.kclique_count(g, kk, device="cuda", rank=rank)
        nk1 = kc.kclique_count(g, kk + 1, device="cuda", rank=rank)
        print(f"[19] k={kk}: {n} cliques (kclique_count {nk}), star total "
              f"{total} = {kk + 1} x {nk1}")
        check(n == nk and total == (kk + 1) * nk1,
              f"star identity fails at k={kk}: {n}, {total}; {nk}, {nk1}")

    # [20] emit mode job by job, counters from 0
    nbrs = [set(g.out_neigh(v).tolist()) for v in range(g.num_nodes)]
    sample = np.sort(np.random.default_rng(SEED).choice(
        STAR_GOLDEN[0], STAR_SAMPLE, replace=False))
    ks.reset_launches()
    rows = stars = 0
    picked = []
    t0 = time.perf_counter()
    for chunk, ww in jobs:
        _, out = ks.star_fused_chunk(pg.nbr, rank_pad, chunk, w_words=ww,
                                     k=k, emit=True)
        gid, members, star_ids = ks.decode_star_rows(pg.nbr, chunk, out)
        stars += int(popcount32(out[:, ww:2 * ww]).sum())
        mine = sample[(sample >= rows) & (sample < rows + out.shape[0])]
        idx = torch.from_numpy(mine - rows).cuda()
        picked += zip(gid[idx].tolist(), members[idx].tolist(),
                      star_ids[idx].tolist())
        rows += out.shape[0]
        del out, gid, members, star_ids
    torch.cuda.synchronize()
    emit_s = time.perf_counter() - t0
    enum = dict(ks.LAUNCHES)
    check((rows, stars) == STAR_GOLDEN,
          f"RMAT {STAR_SCALE} emit: {rows} rows, star popcounts {stars}")
    check(enum["decode_star_rows"] == len(jobs) and
          enum["build_local_univ"] == len(jobs),
          f"a star kernel of the emit path did not run on every job: {enum}")
    for gid, members, star_ids in picked:
        clique = [gid, *(m for m in members if m >= 0)]
        common = set.intersection(*(nbrs[v] for v in clique))
        check(all(b in nbrs[a] for i, a in enumerate(clique)
                  for b in clique[i + 1:])
              and {s for s in star_ids if s >= 0} == common - set(clique),
              f"RMAT {STAR_SCALE}: a sampled row is not a clique with its "
              f"star: {clique}")
    check(len(picked) == STAR_SAMPLE, f"sampled {len(picked)} rows")
    print(f"[20] RMAT {STAR_SCALE} emit: {rows} rows, star popcounts {stars} "
          f"in {len(jobs)} jobs, {emit_s:.4f} s (count pass, emit pass, "
          f"decode); launches {enum}; {STAR_SAMPLE} sampled rows are cliques "
          f"whose stars equal their common neighbourhoods")

    def emit_pass():
        n_rows = 0
        for chunk, ww in jobs:
            _, out = ks.star_fused_chunk(pg.nbr, rank_pad, chunk, w_words=ww,
                                         k=k, emit=True)
            ks.decode_star_rows(pg.nbr, chunk, out)
            n_rows += out.shape[0]
            del out
        return n_rows

    again, host_s, per, busy = profile_window(emit_pass)
    check(again == rows, f"the profiled emit pass gave {again} rows")
    sums = window_lines("[20] the emit pass again under torch.profiler:",
                        host_s, per, busy, STAR_GROUPS)
    check(sums["K11"][1] == len(jobs), f"the profiled emit pass traced "
          f"{sums['K11'][1]} K11 launches for {len(jobs)} jobs")

    # [21] list mode against the oracle and the plain run
    for kk in (2, 3, 4):
        rg = np.triu(np.random.default_rng(kk).random((30, 30)) < 0.3, 1)
        rg = build_csr(np.stack(np.nonzero(rg), 1).astype(np.int64),
                       num_nodes=30)
        got = ks.kclique_star_list(rg, kk, device="cuda")
        want = ks.kclique_star_oracle(rg, kk)
        check(len(got) == len(want) and set(got) == set(want),
              f"random graph k={kk}: {len(got)} pairs, oracle {len(want)}")
    small = build_csr(generate_rmat_el(STAR_SMALL, DEGREE, seed=SEED),
                      num_nodes=1 << STAR_SMALL)
    got = ks.kclique_star_list(small, 3, device="cuda")
    t0 = time.perf_counter()
    want = ks.kclique_star_list(small, 3, device="cpu")
    cpu_s = time.perf_counter() - t0
    check(len(got) == len(want) and set(got) == set(want),
          f"RMAT {STAR_SMALL} k=3 list: {len(got)} pairs, plain {len(want)}")
    print(f"[21] random graphs k=2..4 equal the oracle; RMAT {STAR_SMALL} k=3 "
          f"list ({len(got)} pairs) equals the device='cpu' run "
          f"({cpu_s:.2f} s)")

    # [22] each kernel against its plain version, job by job
    rates = (sm_rate(POPC_PER_CLOCK_PER_SM), sm_rate(BITWISE_PER_CLOCK_PER_SM))
    nbr = pg.nbr
    univ_calls, decode_calls, stack, emit_bytes = [], [], [], []
    for chunk, ww in jobs:
        label = f"W={32 * ww} C={chunk.numel()}"
        univ_calls.append((
            label,
            lambda c=chunk, w=ww: ks.build_local_univ(nbr, rank_pad, c,
                                                      w_words=w),
            lambda c=chunk, w=ww: ks.build_local_univ_plain(nbr, rank_pad, c,
                                                            w_words=w),
            univ_bytes(pg, chunk, ww)))
        univ = (*ks.build_local_univ(nbr, rank_pad, chunk, w_words=ww),
                chunk != pg.v_pad)
        stack.append(search_compare(
            timing, f"RMAT {STAR_SCALE} {label}",
            lambda emit, u=univ: ks.star_stack(*u, k=k, emit=emit),
            lambda emit, stats, u=univ: ks.star_stack_plain(
                *u, k=k, emit=emit, stats=stats),
            star_stack_bytes(*univ, k), rates))
        _, out = ks.star_stack(*univ, k=k, emit=True)
        emit_bytes.append(out.numel() * 4)
        decode_calls.append((
            f"{label} L={out.shape[0]}",
            lambda c=chunk, o=out: ks.decode_star_rows(nbr, c, o),
            lambda c=chunk, o=out: ks.decode_star_rows_plain(nbr, c, o),
            star_decode_bytes(pg, chunk, out)))
    for name, calls, launches in (("build_local_univ", univ_calls, main),
                                  ("decode_star_rows", decode_calls, enum)):
        err, k_ms, p_ms, bound_ms, by = compare(timing, calls, plain_reps=1)
        print(f"[22] {name}: {len(calls)} jobs, max_abs_err {err}, kernel "
              f"{k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
              f"{p_ms:.4f} ms")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        report.append(kernel_entry(name, launches[name], err, k_ms, p_ms,
                                   bound_ms, by))
        del calls[:]
    err, k_ms, e_ms, p_ms, popc, bit, bound, by, _ = search_summary(stack)
    # the emit pass's bound a job: its operations, or the count pass's bytes
    # and the rows written
    emit_bound = sum(max(r[5], r[4] + rb / HBM_BYTES_PER_S * 1e3)
                     for r, rb in zip(stack, emit_bytes))
    print(f"[22] star_stack: {len(stack)} of {len(jobs)} jobs held against the "
          f"plain version (count and emitted rows), max_abs_err {err}, "
          f"kernel {k_ms:.4f} ms (emit {e_ms:.4f} ms), bound {bound:.4f} ms "
          f"({by}; {popc} popcounts, {bit} bitwise ops; the emit pass "
          f"{emit_bound:.4f} ms, {sum(emit_bytes)} bytes of rows written "
          f"besides), plain {p_ms:.4f} ms")
    check(err == 0, f"star_stack disagrees with its plain version by {err}")
    report.append(kernel_entry("star_stack", main["star_stack"], err, k_ms,
                               p_ms, bound, by))


def host_triangles_at(g, v) -> int:
    """Triangles at v, recounted on the host: Σ_{w∈N(v)} |N(v) ∩ N(w)| / 2."""
    nv = g.out_neigh(v)
    if not len(nv):
        return 0
    mark = np.zeros(g.num_nodes, dtype=bool)
    mark[nv] = True
    nn = np.concatenate([g.out_neigh(int(w)) for w in nv])
    return int(mark[nn].sum()) // 2


def distinct_bytes(*tensors) -> int:
    """Bytes of device memory the contiguous `tensors` cover together: views
    that overlap (phase 27's rows v and v+1) count once."""
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for t in tensors)
    total, end = 0, 0
    for lo, hi in spans:
        total += max(hi - max(lo, end), 0)
        end = max(end, hi)
    return total


def adg_bytes(g, alive, peel) -> int:
    """K17's bytes for one round: deg and alive read, peel and alive
    written, and for each vertex that stays alive (the pull walks it) its two
    indptr entries, its CSR row and its deg written."""
    walked = (alive & ~peel).cpu().numpy()
    row_words = int(g.degrees[walked].sum())
    n, w = g.num_nodes, int(walked.sum())
    return 8 * n + 3 * n + 16 * w + 4 * row_words + 8 * w


def vertex_phases(timing, report, g) -> None:
    """Phases 23-28: per-vertex and dense triangles, the device ADG and the
    bitmap counts (see the module docstring); g is phase 2's RMAT-18."""
    from gms_tpu_torch.algorithms import triangle_count as tc
    from gms_tpu_torch.bench.profiling import profile_window, window_lines
    from gms_tpu_torch.graphs.bitmap import BitmapGraph
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.preprocessing import degeneracy, orient
    from gms_tpu_torch.sets import bitmap_ops as bo

    # [23] per-vertex main path, counters from 0
    t0 = time.perf_counter()
    pg, parts = tc.plan_per_vertex(g, device="cuda")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    tc.reset_launches()
    t0 = time.perf_counter()
    pv = tc.triangle_count_per_vertex(g, device="cuda")
    call_s = time.perf_counter() - t0
    pv_launches = dict(tc.LAUNCHES)
    print(f"[23] RMAT {SCALE} per-vertex: Σ {int(pv.sum())} (3 x {GOLDEN} = "
          f"{3 * GOLDEN}); call {call_s:.4f} s (host clock to the read-back; "
          f"host plan alone {plan_s:.4f} s: orient, pad, 2-D tiers, copies); "
          f"max {int(pv.max())}; launches {pv_launches}")
    print(f"    D_pad {pg.d_pad}; {len(parts)} tiers (wa,wb): edges "
          + " · ".join(f"({wa},{wb}): {int(v.sum())}"
                       for wa, wb, _, _, v in parts))
    check(int(pv.sum()) == 3 * GOLDEN, f"per-vertex Σ {int(pv.sum())}")
    check(pv_launches["count_dag_edges_per_vertex"] == len(parts)
          == K14_MAIN_LAUNCHES,
          f"K14 launched {pv_launches} for {len(parts)} tiers")
    pv_warm, host_s, per, busy = profile_window(
        lambda: tc.triangle_count_per_vertex(g, device="cuda"))
    check(np.array_equal(pv_warm, pv), "the profiled per-vertex call differs")
    k14_whole = window_lines(
        f"[23] warm RMAT {SCALE} per-vertex call under torch.profiler:",
        host_s, per, busy, {"K14": K14_KERNELS})["K14"]
    check(k14_whole[0] > 0, "torch.profiler traced no K14 time")
    top = np.argsort(-g.degrees, kind="stable")[:PV_TOP]
    rng = np.random.default_rng(SEED)
    sample = np.union1d(rng.choice(g.num_nodes, PV_SAMPLE, replace=False), top)
    t0 = time.perf_counter()
    bad = [int(v) for v in sample if pv[v] != host_triangles_at(g, int(v))]
    print(f"    {len(sample)} sampled vertices (the {PV_TOP} of highest "
          f"degree among them, {int(pv[top].sum())} triangle corners) equal "
          f"the host recount: {not bad} ({time.perf_counter() - t0:.2f} s)")
    check(not bad, f"per-vertex counts differ from the host at {bad[:10]}")

    # [24] the triangle-count ordering
    t0 = time.perf_counter()
    rank = degeneracy.triangle_count_ordering_rank(g, device="cuda")
    rank_s = time.perf_counter() - t0
    order = degeneracy.rank_to_order(rank)
    c = pv[order]
    check(np.array_equal(np.sort(rank), np.arange(g.num_nodes)),
          "the TC ordering is not a permutation")
    check(bool(np.all((np.diff(c) > 0) | ((np.diff(c) == 0)
                                          & (np.diff(order) > 0)))),
          "the TC ordering is not by (count, id)")
    print(f"[24] triangle_count_ordering_rank: a permutation by (count, id), "
          f"{rank_s:.4f} s")

    # [25] dense-bitmap triangles at RMAT 16, counters from 0
    g16 = build_csr(generate_rmat_el(DENSE_SCALE, DEGREE, seed=SEED),
                    num_nodes=1 << DENSE_SCALE)
    want = tc.TrianglePlan(g16, device="cuda").run()
    dag = orient.orient(g16, orient.degree_rank(g16))
    t0 = time.perf_counter()
    bg = BitmapGraph.from_csr(dag, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tc.reset_launches()
    t0 = time.perf_counter()
    got = tc.triangle_count_dense(g16, device="cuda")
    dense_s = time.perf_counter() - t0
    dense_launches = dict(tc.LAUNCHES)
    nbytes = bg.words.numel() * 4
    print(f"[25] RMAT {DENSE_SCALE} dense: {got}, TrianglePlan {want}; bitmap "
          f"{tuple(bg.words.shape)} {nbytes} bytes, host build and copy "
          f"{build_s:.4f} s; call {dense_s:.4f} s (host clock, the bitmap "
          f"build included); {dag.num_edges} DAG edges; launches "
          f"{dense_launches}")
    check(got == want, f"dense count {got} != TrianglePlan's {want}")
    check(nbytes == DENSE_BYTES, f"bitmap bytes {nbytes}")
    check(dense_launches["count_hub_edges"] == 1,
          f"K15 launched {dense_launches}")

    # [26] the device ADG at RMAT 18, the counter set to 0 just before each
    # run; the main path's run is ADG_MAIN's
    for boundary in ("avg", "min"):
        for eps in ADG_EPS:
            degeneracy.reset_launches()
            t0 = time.perf_counter()
            r = degeneracy.adg_ordering_rank_device(g, eps, boundary,
                                                    device="cuda")
            dev_s = time.perf_counter() - t0
            rounds = degeneracy.LAUNCHES["adg_round"]
            if (boundary, eps) == ADG_MAIN:
                adg_launches = dict(degeneracy.LAUNCHES)
            t0 = time.perf_counter()
            h = degeneracy.adg_ordering_rank(g, eps, boundary)
            host_s = time.perf_counter() - t0
            print(f"[26] ADG {boundary} eps {eps}: {rounds} rounds, device "
                  f"{dev_s:.4f} s, host {host_s:.4f} s, equal "
                  f"{np.array_equal(r, h)}")
            check(np.array_equal(r, h),
                  f"device ADG {boundary} eps {eps} differs from the host's")
    g14 = build_csr(generate_rmat_el(ADG_VERIFY_SCALE, DEGREE, seed=SEED),
                    num_nodes=1 << ADG_VERIFY_SCALE)
    for boundary in ("prob_min", "prob_median"):
        degeneracy.reset_launches()
        t0 = time.perf_counter()
        r1 = degeneracy.adg_ordering_rank_device(g, 0.1, boundary, seed=SEED,
                                                 device="cuda")
        dev_s = time.perf_counter() - t0
        rounds = degeneracy.LAUNCHES["adg_round"]
        r2 = degeneracy.adg_ordering_rank_device(g, 0.1, boundary, seed=SEED,
                                                 device="cuda")
        r14 = degeneracy.adg_ordering_rank_device(g14, 0.1, boundary,
                                                  seed=SEED, device="cuda")
        ok = degeneracy.verify_approx_degeneracy_order(g14, r14, 0.1)
        d14 = color_digest(r14)
        print(f"[26] ADG {boundary} eps 0.1 seed {SEED}: {rounds} rounds, "
              f"device {dev_s:.4f} s; the same rank twice "
              f"{np.array_equal(r1, r2)}; a permutation "
              f"{np.array_equal(np.sort(r1), np.arange(g.num_nodes))}; RMAT "
              f"{ADG_VERIFY_SCALE} passes the verifier {ok}, rank digest "
              f"{d14} (gms_tpu {ADG_PROB_GOLDEN[boundary]})")
        check(np.array_equal(r1, r2) and ok and np.array_equal(
            np.sort(r1), np.arange(g.num_nodes)), f"device ADG {boundary}")
        check(d14 == ADG_PROB_GOLDEN[boundary],
              f"device ADG {boundary} at RMAT {ADG_VERIFY_SCALE}: ranks "
              f"differ from gms_tpu's")
    print(f"[26] main path ({ADG_MAIN[0]} eps {ADG_MAIN[1]}) launches "
          f"{adg_launches}")
    check(adg_launches["adg_round"] > 0, f"K17 {adg_launches}")

    # [27] bitmap counts on RMAT 16's rows, row v against row v+1
    a, b = bg.words[:-1], bg.words[1:]
    bo.reset_launches()
    counts = {"card_a": bo.cardinality(a), "card_b": bo.cardinality(b),
              "and": bo.intersect_count(a, b), "or": bo.union_count(a, b),
              "andnot": bo.difference_count(a, b)}
    bm_launches = dict(bo.LAUNCHES)
    ca, cb, i, u, d = (counts[k].long() for k in counts)
    deg16 = torch.zeros(bg.v_pad, dtype=torch.int64, device="cuda")
    deg16[:dag.num_nodes] = torch.from_numpy(dag.degrees.astype(np.int64))
    deg16 = deg16[:-1]
    ok = (torch.equal(u, ca + cb - i) and torch.equal(d, ca - i)
          and torch.equal(ca, deg16) and bool((i <= torch.minimum(ca, cb)).all()))
    print(f"[27] bitmap_ops on {a.shape[0]} row pairs: Σ |A| {int(ca.sum())}, "
          f"Σ |A∩B| {int(i.sum())}, Σ |A∪B| {int(u.sum())}, Σ |A∖B| "
          f"{int(d.sum())}; |A∪B| = |A|+|B|-|A∩B|, |A∖B| = |A|-|A∩B|, |A| = "
          f"out-degree: {ok}; launches {bm_launches}")
    check(ok, "bitmap_ops counts break the set identities")
    check(bm_launches["bitmap_rows_count"] == 5, f"K16 {bm_launches}")

    # [28] each kernel against its plain version, exactly
    rate = sm_rate(POPC_PER_CLOCK_PER_SM)
    k14 = [(f"({wa},{wb}) E={e.shape[0]}",
            lambda e=e, v=v, wa=wa, wb=wb: tc.count_dag_edges_per_vertex(
                pg.nbr, e, v, num_segments=pg.v_pad, width_a=wa, width_b=wb),
            lambda e=e, v=v, wa=wa, wb=wb, c=c:
                tc.count_dag_edges_per_vertex_plain(
                    pg.nbr, e, v, num_segments=pg.v_pad, chunk=c,
                    width_a=wa, width_b=wb),
            (distinct_data_words(pg.deg, [(e[v > 0, 0], wa), (e[v > 0, 1], wb)])
             + e.numel() + v.numel() + 2 * pg.v_pad) * 4)
           for wa, wb, c, e, v in parts]
    edges, valid = tc._pad_edges(dag.edge_array(), 1024)
    edges, valid = torch.from_numpy(edges).cuda(), torch.from_numpy(valid).cuda()
    W = bg.w_pad
    used = torch.unique(edges[valid > 0].reshape(-1)).numel()
    k15 = [(f"RMAT {DENSE_SCALE} E={int(valid.sum())} W={W}",
            lambda: tc.count_hub_edges(bg.words, None, edges, valid,
                                       chunk=1024),
            lambda: tc.count_hub_edges_plain(bg.words, None, edges, valid,
                                             chunk=1024),
            (used * W + edges.numel() + valid.numel()) * 4 + 8,
            int(valid.sum()) * W)]
    k16 = [(f"{op} B={a.shape[0]} W={W}",
            lambda op=op: bo.rows_count(a, b, op=op),
            lambda op=op: bo.rows_count_plain(a, b, op=op),
            distinct_bytes(a, *([] if op == "card" else [b]))
            + a.shape[0] * 4, a.numel())
           for op in ("card", "and", "or", "andnot")]
    for name, calls, launches in (
            ("count_dag_edges_per_vertex", k14, pv_launches),
            ("count_hub_edges", k15, dense_launches),
            ("bitmap_rows_count", k16, bm_launches)):
        err, k_ms, p_ms, bound_ms, by = compare(timing, calls, ops_rate=rate,
                                                plain_reps=1)
        whole = (f"; over the warm call (phase 23) {k14_whole[0]:.4f} ms of "
                 f"device time, {k14_whole[1]} launches traced"
                 if name == "count_dag_edges_per_vertex" else "")
        print(f"[28] {name}: {len(calls)} launches, max_abs_err {err}, kernel "
              f"{k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
              f"{p_ms:.4f} ms{whole}")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        report.append(kernel_entry(name, launches[name], err, k_ms, p_ms,
                                   bound_ms, by))
    del bg, a, b, edges, valid
    # K17 on every round state of the main path's run (ADG_MAIN), so that
    # its times and bound cover the launches it reports; each rep restores
    # the round's state first, untimed
    boundary, eps = ADG_MAIN
    indptr = torch.from_numpy(g.indptr).cuda()
    indices = torch.from_numpy(g.indices).cuda()
    deg = torch.from_numpy(g.degrees.astype(np.int64)).cuda()
    alive = torch.ones(g.num_nodes, dtype=torch.bool, device="cuda")
    err, k_ms, p_ms, bound_ms, rnd = 0, 0.0, 0.0, 0.0, 0
    while bool(alive.any()):
        deg0, alive0 = deg.clone(), alive.clone()
        pd, pa = deg0.clone(), alive0.clone()

        def restore(d0=deg0, a0=alive0):
            deg.copy_(d0)
            alive.copy_(a0)

        def kernel():
            return degeneracy.adg_round(indptr, indices, deg, alive,
                                        boundary=boundary, eps=eps)

        def plain(d0=deg0, a0=alive0, pd=pd, pa=pa):
            pd.copy_(d0)
            pa.copy_(a0)
            return degeneracy.adg_round_plain(indptr, indices, pd, pa,
                                              boundary=boundary, eps=eps)

        kt = timing.ms(kernel, KERNEL_REPS, setup=restore)
        pt = timing.ms(plain, PLAIN_REPS)
        want = plain()
        restore()
        peel = kernel()          # leaves the next round's state in deg, alive
        diff = max(max_abs_err(peel, want), max_abs_err(deg, pd),
                   max_abs_err(alive, pa))
        nbytes = adg_bytes(g, alive0, want)
        bt = nbytes / HBM_BYTES_PER_S * 1e3
        rnd += 1
        print(f"    adg_round {boundary} eps {eps} round {rnd} "
              f"({int(alive0.sum())} alive, {int(want.sum())} peel): "
              f"max_abs_err {diff}, kernel {kt:.4f} ms, bound {bt:.4f} ms "
              f"({nbytes} bytes), plain {pt:.4f} ms (its state copy "
              f"included)")
        err, k_ms, p_ms, bound_ms = (max(err, diff), k_ms + kt, p_ms + pt,
                                     bound_ms + bt)
    print(f"[28] adg_round: the {rnd} rounds of {boundary} eps {eps}, "
          f"max_abs_err {err}, kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"(bytes), plain {p_ms:.4f} ms")
    check(rnd == adg_launches["adg_round"],
          f"{rnd} round states, {adg_launches} on the main path")
    check(err == 0, f"adg_round disagrees with its plain version by {err}")
    report.append(kernel_entry("adg_round", adg_launches["adg_round"], err,
                               k_ms, p_ms, bound_ms, "bytes"))


def score_err(got, want) -> float:
    """Largest |got - want| of two float score arrays, NaN equal to NaN (0)
    and inf to inf; a NaN or inf against anything else is inf."""
    got, want = got.double(), want.double()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    diff = torch.where(same, 0.0, (got - want).abs())
    return float(torch.nan_to_num(diff, nan=math.inf).max()) if diff.numel() \
        else 0.0


def topq_err(got, want) -> float:
    """tile_topq outputs (scores, u, v): the scores' error, inf if the pairs
    differ."""
    if got[0].shape != want[0].shape or not (
            torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
        return math.inf
    return score_err(got[0], want[0])


def scores_close(got, want, metric) -> bool:
    """Kernel against plain: bit for bit for the count metrics, rtol 1e-5
    for AA/RA (float32 weights summed in another order)."""
    if metric not in ("adamic_adar", "resource"):
        return score_err(got, want) == 0.0
    return bool(torch.allclose(got, want, rtol=1e-5, atol=0.0,
                               equal_nan=True))


def keyed_isolated_topq(g, q: int, block: int):
    """gms_tpu's top-q rule where the top scores are ties: the best q of
    each u-block by (strip of v, u, v) among the pairs of isolated vertices
    (Jaccard 1.0; any other pair scores at most 1/3), then the first q of
    their union by (u, v)."""
    iso = np.nonzero(g.degrees == 0)[0]
    n = g.num_nodes
    block = min(block, -(-n // 128) * 128)
    n_pad = -(-n // block) * block
    picks = []
    for start in range(0, n, block):
        us = iso[(iso >= start) & (iso < start + block)]
        got = []
        for vb in range(start, n_pad, block):
            if len(got) >= q or not len(us):
                break
            vs_ = iso[(iso >= vb) & (iso < vb + block)]
            uu, vv = np.meshgrid(us, vs_, indexing="ij")
            keep = vv > uu
            got.extend(zip(uu[keep].tolist(), vv[keep].tolist()))
        picks.extend(got[:q])
    return sorted(picks)[:q]


def probed_words(nbr, deg, pairs, hub_idx, vw, n_words) -> int:
    """Distinct hub bitmap words K19 tests for `pairs` (each u-row element's
    word of v's bitmap)."""
    seen = torch.zeros(n_words, dtype=torch.bool, device=nbr.device)
    for s in range(0, pairs.shape[0], 4096):
        p = pairs[s:s + 4096].long()
        w = int(deg[p[:, 0]].max())
        rows = nbr[p[:, 0], :max(w, 1)].long()
        h = hub_idx[p[:, 1]].long()
        ok = rows != 0x7FFFFFFF
        widx = h[:, None] * vw + (rows.clamp(0, 32 * vw - 1) >> 5)
        seen[widx[ok]] = True
    return int(seen.sum())


def host_bitmap(g, n_pad: int) -> np.ndarray:
    """uint32[n_pad, n_pad/32] id-space bitmap rows, as gms_tpu builds them
    (the layout row 14b's bound of record counts)."""
    n = g.num_nodes
    bm = np.zeros((n_pad, n_pad // 32), np.uint32)
    u = np.repeat(np.arange(n, dtype=np.int64), g.degrees.astype(np.int64))
    v = g.indices.astype(np.int64)
    np.bitwise_or.at(bm, (u, v >> 5), np.uint32(1) << (v & 31).astype(np.uint32))
    return bm


def nonzero_word_pairs(u_words, v_words, upper: bool) -> int:
    """AND+popcounts a tile call's function needs: over the (u, v) pairs it
    scores, the word columns where both rows' words are non-zero (a zero
    word adds nothing to any metric). With upper, u_words are the first rows
    of v_words (a u-block and the strips from its diagonal) and only v > u
    counts."""
    zu = (u_words != 0).long()
    zv = v_words != 0
    col = zv.sum(0, dtype=torch.int64)
    if not upper:
        return int((zu.sum(0) * col).sum())
    after = col[None, :] - torch.cumsum(zv[:zu.shape[0]].long(), 0)
    return int((zu * after).sum())


def wedges_above(indptr, indices, u0: int, u1: int) -> int:
    """Wedges u - x - v with u in [u0, u1) and v > u: the shared-memory
    additions K21 needs for that u-block (CSR rows sorted)."""
    n = indptr.shape[0] - 1
    a, b = min(u0, n), min(u1, n)
    deg = indptr[a + 1:b + 1] - indptr[a:b]
    u = torch.repeat_interleave(torch.arange(a, b, device=indices.device), deg)
    x = indices[int(indptr[a]):int(indptr[b])].long()
    rows = torch.repeat_interleave(torch.arange(n, device=indices.device),
                                   indptr[1:] - indptr[:-1])
    keys = rows * n + indices.long()  # ascending: rows sorted, x ascending
    past = torch.searchsorted(keys, x * n + u, right=True)
    return int((indptr[x + 1] - past).sum())


def topq_calls(lp, g, q: int, metric: str, label: str):
    """compare() calls of tile_topq on every u-block of
    link_prediction_similarity(block=LP_BLOCK) at q: the u-block's rows
    against the vertices from its diagonal, on the CSRs and the strip table
    as the call builds them. A call's bound is the function's own: bytes of
    the CSR (indptr and indices; g is undirected, so it is its own
    transpose) and the degrees read once and the q candidates written, or
    operations, the pair finishes (every pair with u < v < n) and the wedges
    u - x - v with v > u, at the 32-bit rate. Also returns each call's bound
    of record (row 14b): the id-space bitmap rows of those strips, their
    degrees and the q candidates, or nonzero_word_pairs."""
    from gms_tpu_torch.algorithms import similarity as vs

    n = g.num_nodes
    n_pad = -(-n // LP_BLOCK) * LP_BLOCK
    bm = torch.from_numpy(host_bitmap(g, n_pad).view(np.int32)).cuda()
    deg_np = np.zeros(n_pad, np.int32)
    deg_np[:n] = g.degrees
    deg_p = torch.from_numpy(deg_np).cuda()
    csr, tcsr = lp.topq_csr(g, "cuda")
    check(tcsr is csr, "an undirected graph's transpose is its own CSR")
    indptr, indices = csr
    strips = lp.strip_table(indptr, indices, n)
    wcol = (vs.column_weights(deg_p, metric, n_pad)
            if metric in vs.WEIGHTED else None)
    nbytes = indptr.numel() * 8 + indices.numel() * 4 + n_pad * 4 + q * 12
    calls, record = [], []
    for start in range(0, n, LP_BLOCK):
        u, v = bm[start:start + LP_BLOCK], bm[start:]
        nu = u.shape[0]
        pairs = nu * (n - start) - nu * (nu + 1) // 2
        kw = dict(u_base=start, nu=LP_BLOCK, v_base=start, nv=n_pad - start,
                  n=n, block=LP_BLOCK, q=q, metric=metric, wcol=wcol,
                  strips=strips)
        calls.append((
            f"{label} u-block {start // LP_BLOCK} ({pairs} pairs; the dense "
            f"design did {pairs * bm.shape[1]} AND+popcounts)",
            lambda kw=kw: lp.tile_topq(indptr, indices, indptr, indices,
                                       deg_p, **kw),
            lambda kw=kw: lp.tile_topq_plain(indptr, indices, indptr,
                                             indices, deg_p, **kw),
            nbytes, pairs + wedges_above(indptr, indices, start,
                                         start + LP_BLOCK)))
        record.append(((v.numel() + (n - start)) * 4 + q * 12,
                       nonzero_word_pairs(u, v, upper=True)))
    return calls, record, bm


def record_bound(record) -> tuple:
    """(ms, bound_by) of row 14b's bound of record summed over calls: the
    bitmap's bytes at 3.35 TB/s against its AND+popcounts at the popcount
    rate, the larger a call."""
    rate = sm_rate(POPC_PER_CLOCK_PER_SM)
    bt = [b / HBM_BYTES_PER_S * 1e3 for b, _ in record]
    ot = [o / rate * 1e3 for _, o in record]
    return (sum(max(b, o) for b, o in zip(bt, ot)),
            "operations" if sum(ot) > sum(bt) else "bytes")


def weighted_topq_fault(g, edges, scores, plain_scores, metric):
    """AA and RA against pair_scores_plain, which sums the same float32
    weights in another order than the top-q: holds each pair the kernels
    returned to what it must be: u < v < n, not an edge, scoring as
    pair_scores_plain on that pair within rtol 1e-5, and the q-th score not
    below plain's q-th by more than that. Returns the first fault, or
    None."""
    from gms_tpu_torch.algorithms import similarity as vs
    from gms_tpu_torch.graphs.tiles import PaddedGraph

    n = g.num_nodes
    if len(edges) != len(plain_scores):
        return f"{len(edges)} pairs, plain {len(plain_scores)}"
    u, v = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    if not ((u < v) & (v < n)).all():
        return "a pair outside u < v < n"
    und = g.undirected_edge_array().astype(np.int64)
    if np.isin(u * n + v, und[:, 0] * n + und[:, 1]).any():
        return "an edge among the pairs"
    pg = PaddedGraph.from_csr(g, device="cuda")
    want = vs.pair_scores_plain(pg.nbr, vs._deg_lookup(pg),
                                torch.from_numpy(edges).cuda(),
                                metric=metric).cpu().numpy()
    if not np.allclose(scores, want, rtol=1e-5, atol=0.0):
        return "a score differs from pair_scores_plain's"
    if len(scores) and scores[-1] < plain_scores[-1] * (1 - 1e-5):
        return f"q-th score {scores[-1]} < plain's {plain_scores[-1]}"
    return None


def lp_phases(timing, report) -> None:
    """Phases 30-35: link prediction and vertex similarity (see the module
    docstring)."""
    from gms_tpu_torch.bench.profiling import profile_window, window_lines
    from gms_tpu_torch.algorithms import link_prediction as lp
    from gms_tpu_torch.algorithms import similarity as vs
    from gms_tpu_torch.graphs.tiles import PaddedGraph
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el

    t0 = time.perf_counter()
    g = build_csr(generate_rmat_el(LP_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << LP_SCALE)
    m = g.num_edges_undirected
    train, test = lp.extract_random_test_edges(g, int(0.01 * m), seed=1)
    print(f"[30] graph RMAT {LP_SCALE}: {g.num_nodes} nodes, {m} undirected "
          f"edges, max degree {g.max_degree}; test split {test.num_edges_undirected}"
          f" edges (seed 1); {time.perf_counter() - t0:.2f} s")

    # [30] AUC main path, counters from 0
    vs.reset_launches()
    lp.reset_launches()
    t0 = time.perf_counter()
    plan = lp.AUCPlan(g, train, test, LP_SAMPLES, metric="jaccard", seed=2,
                      device="cuda")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    warm_t0 = time.perf_counter()
    auc, trial_s = plan.run_steady(LP_TRIALS)
    steady_s = time.perf_counter() - warm_t0
    auc_launches = {"pair_scores": vs.LAUNCHES["pair_scores"],
                    "pair_scores_hub": vs.LAUNCHES["pair_scores_hub"],
                    "auc_count": lp.LAUNCHES["auc_count"]}
    got = [tuple(int(x) for x in row) for row in plan.steady_counts]
    pn, _ = plan._split.merge
    ph, _ = plan._split.hub
    print(f"[30] AUCPlan RMAT {LP_SCALE} Jaccard T={LP_SAMPLES}: host plan "
          f"{plan_s:.4f} s (sampling, tables, split, copies); "
          f"{pn.shape[0]} K18 pairs, {ph.shape[0]} K19 (hub) pairs; "
          f"run_steady({LP_TRIALS}): AUC {auc}, {trial_s * 1e3:.4f} ms a "
          f"trial (host clock to the read-back), both calls {steady_s:.4f} s")
    print(f"    (higher, equal) of the timed trials {got}")
    print(f"    launches {auc_launches}: {LP_TRIALS} in the timed call plus "
          f"{LP_TRIALS} in the first call from shift 0, each")
    check(got == [tuple(x) for x in LP_GOLDEN],
          f"AUC trials {got} != {LP_GOLDEN}")
    check(abs(auc - 0.85176) < 1e-12, f"AUC {auc} != 0.85176")
    check(all(v == 2 * LP_TRIALS for v in auc_launches.values()),
          f"AUC launches {auc_launches}")
    k0 = plan.counts(0, 1)
    p0 = plan._counts_with(0, 1, lp._score_into_plain, lp.auc_count_plain)
    print(f"    run(0): kernels {k0[0].tolist()}, plain {p0[0].tolist()}")
    check(np.array_equal(k0, p0), f"run(0) {k0} != plain {p0}")

    # [31] score_auc, gms_tpu/bench/link_prediction.py's protocol
    train0, test0 = lp.extract_random_test_edges(g, max(1, int(m * 0.01)),
                                                 seed=0)
    # score_auc's own pairs (seed 0), scored by the kernels and by plain
    auc_true, auc_false = lp._auc_pairs(g, test0, LP_SAMPLES, 0)

    def auc_counts(metric, score_into):
        tables = lp._train_tables(train0, "cuda")
        st = lp._pair_scores_np(tables, auc_true, metric, score_into)
        sf = lp._pair_scores_np(tables, auc_false, metric, score_into)
        return int(np.sum(st > sf)), int(np.sum(st == sf))

    for metric in LP_BENCH_METRICS:
        t0 = time.perf_counter()
        auc_k = lp.score_auc(g, train0, test0, LP_SAMPLES, metric=metric,
                             device="cuda")
        call_s = time.perf_counter() - t0
        hk = auc_counts(metric, lp._score_into)
        hp = auc_counts(metric, lp._score_into_plain)
        check((hk[0] + 0.5 * hk[1]) / LP_SAMPLES == auc_k,
              f"score_auc {metric} {auc_k} is not its pairs' count {hk}")
        auc_p = (hp[0] + 0.5 * hp[1]) / LP_SAMPLES
        print(f"[31] score_auc {metric}: {auc_k} ({call_s:.4f} s, host clock, "
              f"sampling included); (higher, equal) kernels {hk}, plain {hp}")
        check(0.0 <= auc_k <= 1.0, f"score_auc {metric} {auc_k}")
        if metric in ("adamic_adar", "resource"):
            check(abs(auc_k - auc_p) <= 1e-4, f"{metric} AUC {auc_k} vs "
                  f"plain {auc_p}")
        else:
            check(hk == hp, f"{metric} counts {hk} != plain {hp}")
    del train0, test0, auc_true, auc_false

    # [32] vertex_similarity, all seven metrics
    rng = np.random.default_rng(SEED)
    hubs = np.nonzero(g.degrees > lp.HUB_THRESHOLD)[0]
    pairs = np.concatenate([
        rng.integers(0, g.num_nodes, (LP_PAIRS, 2)),
        np.stack([rng.integers(0, g.num_nodes, LP_PAIRS),
                  rng.choice(hubs, LP_PAIRS)], axis=1)]).astype(np.int32)
    pg = PaddedGraph.from_csr(g, device="cuda")
    deg1 = vs._deg_lookup(pg)
    tp = torch.from_numpy(pairs).cuda()
    sample = rng.choice(len(pairs), LP_ORACLE, replace=False)
    for metric in vs.METRICS:
        t0 = time.perf_counter()
        got = vs.vertex_similarity(g, pairs, metric, device="cuda")
        call_s = time.perf_counter() - t0
        plain = vs.pair_scores_plain(pg.nbr, deg1, tp, metric=metric)
        want = vs.vertex_similarity_oracle(g, pairs[sample], metric)
        ok_plain = scores_close(torch.from_numpy(got).cuda(), plain, metric)
        ok_oracle = np.allclose(got[sample], want.astype(np.float32),
                                rtol=1e-5, atol=0.0, equal_nan=True)
        print(f"[32] vertex_similarity {metric}: {len(pairs)} pairs "
              f"({LP_PAIRS} with a hub end) in {call_s:.4f} s (host clock, "
              f"padded build included); = plain {ok_plain}; {LP_ORACLE} = "
              f"oracle {ok_oracle}")
        check(ok_plain and ok_oracle, f"vertex_similarity {metric}")
    del pg, deg1, tp

    # [33] top-q ranking, bench.py's call, counters from 0
    lp.reset_launches()
    t0 = time.perf_counter()
    edges, scores = lp.link_prediction_similarity(train, LP_Q,
                                                  metric="jaccard",
                                                  device="cuda")
    rank_s = time.perf_counter() - t0
    rank_launches = dict(lp.LAUNCHES)
    want = keyed_isolated_topq(train, LP_Q, LP_BLOCK)
    got = [tuple(int(x) for x in e) for e in edges]
    us = sorted({u for u, _ in got})
    print(f"[33] link_prediction_similarity RMAT {LP_SCALE} train, q {LP_Q}, "
          f"Jaccard: {rank_s:.4f} s (host clock, the CSR's copy and strip "
          f"table included); launches {rank_launches}; {len(got)} pairs, u in {us},"
          f" first {got[:1]}, last {got[-1:]}; = keyed rule "
          f"{got == want}; scores all 1.0 {bool((scores == 1.0).all())}")
    check(got == want, "top-q pairs differ from the keyed rule")
    check(bool((scores == 1.0).all()), "top-q scores are not all 1.0")
    check(rank_launches["tile_topq"] == -(-train.num_nodes // LP_BLOCK),
          f"K21 launches {rank_launches}")
    (e2, _), host_s, per, busy = profile_window(
        lambda: lp.link_prediction_similarity(train, LP_Q, metric="jaccard",
                                              device="cuda"))
    check([tuple(int(x) for x in e) for e in e2] == want,
          "the profiled top-q call differs")
    window_lines("[33] warm call under torch.profiler:", host_s, per, busy,
                 {"K21": K21_KERNELS})
    # the strip table against the binary search on the same warm call,
    # alternated: K21's device time under the profiler, the host clock
    keep, ab = lp.STRIP_TABLE_BYTES, {"table": [], "search": []}
    for label in ("table", "search", "search", "table", "table", "search"):
        lp.STRIP_TABLE_BYTES = keep if label == "table" else 0
        (e3, _), h, p3, _ = profile_window(
            lambda: lp.link_prediction_similarity(
                train, LP_Q, metric="jaccard", device="cuda"))
        check([tuple(int(x) for x in e) for e in e3] == want,
              f"the top-q call with the {label} differs")
        ab[label].append((sum(p3[k][0] for k in K21_KERNELS) / 1e3, h))
    lp.STRIP_TABLE_BYTES = keep
    for label, runs in ab.items():
        print(f"    [33] row ranges by the {label}: K21 device ms "
              f"{[round(d, 4) for d, _ in runs]}, host s "
              f"{[round(h, 4) for _, h in runs]}")

    # [34] top-q counting against the plain version on the card
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; the plain top-q must count in float32")
    g14 = build_csr(generate_rmat_el(LP_COUNT_SCALE, DEGREE, seed=SEED),
                    num_nodes=1 << LP_COUNT_SCALE)
    for metric in ("common_neighbors", "adamic_adar"):
        t0 = time.perf_counter()
        e_k, s_k = lp.link_prediction_similarity(g14, LP_Q, metric=metric,
                                                 device="cuda")
        k_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        e_p, s_p = lp._link_prediction_similarity_plain(g14, LP_Q,
                                                        metric=metric,
                                                        device="cuda")
        p_s = time.perf_counter() - t0
        same = np.array_equal(e_k, e_p) and np.array_equal(s_k, s_p)
        fault = (None if metric not in vs.WEIGHTED
                 else weighted_topq_fault(g14, e_k, s_k, s_p, metric))
        print(f"[34] RMAT {LP_COUNT_SCALE} top-{LP_Q} {metric}: kernels "
              f"{k_s:.4f} s, plain {p_s:.4f} s; pairs and scores equal "
              f"{same}; each pair checked (AA, RA) {fault or 'ok'}; best "
              f"{s_k[:3]}")
        check(same and fault is None, f"RMAT {LP_COUNT_SCALE} top-q {metric}"
              f" differs from plain: {fault}")
    g12 = build_csr(generate_rmat_el(LP_SMALL_SCALE, DEGREE, seed=SEED),
                    num_nodes=1 << LP_SMALL_SCALE)
    for metric in vs.METRICS:
        e_k, s_k = lp.link_prediction_similarity(
            g12, LP_Q, metric=metric, block=LP_SMALL_BLOCK, device="cuda")
        e_p, s_p = lp._link_prediction_similarity_plain(
            g12, LP_Q, metric=metric, block=LP_SMALL_BLOCK, device="cuda")
        same = np.array_equal(e_k, e_p) and np.array_equal(s_k, s_p)
        fault = None if same else "pairs or scores differ"
        if fault is None and metric in vs.WEIGHTED:
            fault = weighted_topq_fault(g12, e_k, s_k, s_p, metric)
        check(fault is None, f"RMAT {LP_SMALL_SCALE} top-q {metric} differs "
              f"from plain: {fault}")
    print(f"[34] RMAT {LP_SMALL_SCALE} block {LP_SMALL_BLOCK}: the seven "
          f"metrics' top-{LP_Q} equal the plain version's, pairs and score "
          f"bits (AA, RA also: each pair a non-edge u < v < n scoring as "
          f"pair_scores_plain within rtol 1e-5, the q-th score not below "
          f"plain's)")
    n12 = g12.num_nodes
    adj = torch.zeros((n12, n12), dtype=torch.float32, device="cuda")
    e12 = torch.from_numpy(g12.edge_array()).cuda().long()
    adj[e12[:, 0], e12[:, 1]] = 1.0
    d12 = torch.from_numpy(g12.degrees).cuda()
    blk, dblk = adj[:LP_SMALL_BLOCK], d12[:LP_SMALL_BLOCK]
    vs.reset_launches()
    for metric in vs.METRICS:
        got = vs.all_pairs_scores(blk, dblk, adj, d12, metric=metric)
        want = vs.all_pairs_scores_plain(blk, dblk, adj, d12, metric=metric)
        check(scores_close(got, want, metric),
              f"all_pairs_scores {metric} differs from plain")
    ap_launches = dict(vs.LAUNCHES)
    print(f"[34] all_pairs_scores, RMAT {LP_SMALL_SCALE}'s first "
          f"{LP_SMALL_BLOCK} rows x {n12}: the seven metrics equal the plain "
          f"version's; launches {ap_launches}")
    check(ap_launches["tile_all_pairs"] == len(vs.METRICS),
          f"tile_all_pairs launches {ap_launches}")

    # [35] each kernel against its plain version, CUDA-event times
    rate = sm_rate(POPC_PER_CLOCK_PER_SM)
    pgt, deg1t, bm, hub_idx, vw = plan._tables
    dev_deg = pgt.deg
    B2 = 2 * LP_SAMPLES

    def pair_bytes(p, uses):
        """pairs, their deg1 entries, the rows `uses` reads, the output."""
        ends = torch.unique(p.reshape(-1)).numel()
        return (p.numel() + ends + distinct_data_words(dev_deg, uses)
                + p.shape[0]) * 4

    k18 = [(f"K18 Jaccard, {pn.shape[0]} of phase 30's pairs",
            lambda: vs.pair_scores(pgt.nbr, deg1t, pn, metric="jaccard"),
            lambda: vs.pair_scores_plain(pgt.nbr, deg1t, pn, metric="jaccard"),
            pair_bytes(pn, [(pn[:, 0], pgt.d_pad), (pn[:, 1], pgt.d_pad)]))]
    probed = probed_words(pgt.nbr, dev_deg, ph, hub_idx, vw, bm.shape[0])
    k19 = [(f"K19 Jaccard, {ph.shape[0]} hub pairs of phase 30",
            lambda: vs.pair_scores_hub(pgt.nbr, deg1t, bm, hub_idx, ph,
                                       metric="jaccard", vw=vw),
            lambda: vs.pair_scores_hub_plain(pgt.nbr, deg1t, bm, hub_idx, ph,
                                             metric="jaccard", vw=vw),
            pair_bytes(ph, [(ph[:, 0], pgt.d_pad)])
            + (probed + torch.unique(ph[:, 1]).numel()) * 4)]
    sc = plan._scores.clone()
    shift = torch.ones(1, dtype=torch.int32, device="cuda")
    cnt = torch.zeros(2, dtype=torch.int32, device="cuda")
    pshift, pcnt = shift.clone(), cnt.clone()

    def k20():
        shift.fill_(1)
        lp.auc_count(sc, shift, cnt)
        return torch.cat([cnt, shift])

    def k20_plain():
        pshift.fill_(1)
        lp.auc_count_plain(sc, pshift, pcnt)
        return torch.cat([pcnt, pshift])

    k20c = [(f"K20 on phase 30's {B2} scores, shift 1", k20, k20_plain,
             B2 * 4 + 4 + 8 + 4)]
    for name, calls, launches in (("pair_scores", k18, auc_launches),
                                  ("pair_scores_hub", k19, auc_launches),
                                  ("auc_count", k20c, auc_launches)):
        err, k_ms, p_ms, bound_ms, by = compare(timing, calls, ops_rate=rate,
                                                err_fn=score_err)
        print(f"[35] {name}: max_abs_err {err}, kernel {k_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}), plain {p_ms:.4f} ms")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        report.append(kernel_entry(name, launches[name], err, k_ms, p_ms,
                                   bound_ms, by))
    # phase 54 scores phase 30's K18 pairs again
    lp_pairs = (pgt.nbr, deg1t, pn)
    del plan, pgt, deg1t, bm, hub_idx, pn, ph, sc

    # K21 tile_topq on every u-block of phase 33's call (bench.py's ranking
    # call at RMAT-16), then of the whole RMAT-14 CN and AA calls and of an
    # RMAT-14 call at q = 10,000
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    t16, record, bm16 = topq_calls(lp, train, LP_Q, "jaccard",
                                   f"tile_topq RMAT {LP_SCALE} Jaccard")
    bit_rate = sm_rate(BITWISE_PER_CLOCK_PER_SM)
    err, k_ms, p_ms, bound_ms, by = compare(timing, t16, ops_rate=bit_rate,
                                            err_fn=topq_err)
    check(err == 0, f"tile_topq disagrees with its plain version by {err}")
    # the library call: torch.matmul of each u-block's common counts
    dense16 = vs.unpack_rows(bm16)
    del bm16
    lib_ms = 0.0
    for start in range(0, train.num_nodes, LP_BLOCK):
        u, v = dense16[start:start + LP_BLOCK], dense16[start:]
        lib_ms += timing.ms(lambda u=u, v=v: torch.matmul(u, v.T), PLAIN_REPS)
    del dense16, u, v
    rec_ms, rec_by = record_bound(record)
    print(f"[35] tile_topq, phase 33's RMAT {LP_SCALE} call ({len(t16)} "
          f"launches): max_abs_err {err}, kernel {k_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}: the CSR and degrees read, the pair "
          f"finishes and wedges), plain {p_ms:.4f} ms, torch.matmul of its "
          f"common counts (float32, TF32 off) {lib_ms:.4f} ms")
    print(f"    row 14b's bound of record, the bitmap layout's: {rec_ms:.4f} "
          f"ms ({rec_by}: {sum(b for b, _ in record)} bytes, "
          f"{sum(o for _, o in record)} AND+popcounts)")
    check(len(t16) == rank_launches["tile_topq"],
          f"{len(t16)} u-blocks timed, {rank_launches} on the main path")
    report.append(kernel_entry("tile_topq", rank_launches["tile_topq"], err,
                               k_ms, p_ms, bound_ms, by, library_ms=lib_ms))
    for metric, q in (("common_neighbors", LP_Q), ("adamic_adar", LP_Q),
                      ("jaccard", LP_BIG_Q)):
        calls, record, _ = topq_calls(
            lp, g14, q, metric, f"tile_topq RMAT {LP_COUNT_SCALE} {metric} "
            f"q={q}")
        err, k_ms, p_ms, bound_ms, by = compare(
            timing, calls, ops_rate=bit_rate, err_fn=topq_err)
        rec_ms, rec_by = record_bound(record)
        print(f"[35] tile_topq, the whole RMAT {LP_COUNT_SCALE} {metric} call"
              f" at q {q} ({len(calls)} launches): max_abs_err {err}, kernel "
              f"{k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), the bitmap's "
              f"bound of record {rec_ms:.4f} ms ({rec_by}), plain "
              f"{p_ms:.4f} ms")
        check(err == 0, f"tile_topq RMAT {LP_COUNT_SCALE} {metric} q={q} "
                        f"disagrees by {err}")

    # tile_all_pairs on phase 34's block, Jaccard
    ub, va = vs.pack_rows(blk), vs.pack_rows(adj)
    tap = [(f"tile_all_pairs RMAT {LP_SMALL_SCALE} {LP_SMALL_BLOCK} x {n12} "
            f"Jaccard",
            lambda: vs.tile_all_pairs(ub, va, dblk, d12, metric="jaccard"),
            lambda: vs.all_pairs_scores_plain(blk, dblk, adj, d12,
                                              metric="jaccard"),
            (ub.numel() + va.numel() + LP_SMALL_BLOCK + n12
             + LP_SMALL_BLOCK * n12) * 4,
            nonzero_word_pairs(ub, va, upper=False))]
    err, k_ms, p_ms, bound_ms, by = compare(timing, tap, ops_rate=rate,
                                            err_fn=score_err)
    lib_ms = timing.ms(lambda: torch.matmul(blk, adj.T), KERNEL_REPS)
    print(f"    (the dense design does {LP_SMALL_BLOCK * n12 * ub.shape[1]} "
          f"AND+popcounts, one for every word of every pair)")
    print(f"[35] tile_all_pairs: max_abs_err {err}, kernel {k_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({by}), plain {p_ms:.4f} ms, torch.matmul"
          f" of its common counts {lib_ms:.4f} ms")
    check(err == 0, f"tile_all_pairs disagrees with its plain version by {err}")
    report.append(kernel_entry("tile_all_pairs", ap_launches["tile_all_pairs"],
                               err, k_ms, p_ms, bound_ms, by,
                               library_ms=lib_ms))
    return lp_pairs


def color_digest(colors) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        colors, dtype=np.int32).tobytes()).hexdigest()[:16]


class RoundStates:
    """Records a coloring run's round-start states: inside the `with` block
    the coloring module's round function `fn` (the entry points call it only
    while a vertex is uncolored) is wrapped to copy its inputs before each
    call. Keeps the first and the last. The positional inputs at `keep`,
    which the round only reads, are kept as the call's own tensors (a row
    schedule is taken only with the indptr it was built from). With
    every=True, keeps every call's inputs in `every`."""

    def __init__(self, gc, fn: str, keep=(), every=False):
        self.gc, self.fn, self.keep = gc, fn, keep
        self.first = self.last = None
        self.every = [] if every else None
        self.rounds = 0

    def __enter__(self):
        inner = self.inner = getattr(self.gc, self.fn)

        def record(*state, **kw):
            snap = tuple(x.clone() if isinstance(x, torch.Tensor)
                         and i not in self.keep else x
                         for i, x in enumerate(state)) + (kw,)
            if self.first is None:
                self.first = snap
            self.last = snap
            if self.every is not None:
                self.every.append(snap)
            self.rounds += 1
            return inner(*state, **kw)

        setattr(self.gc, self.fn, record)
        return self

    def __exit__(self, *exc):
        setattr(self.gc, self.fn, self.inner)

    def both(self):
        """[(label, state)] of the first and the last round."""
        k = self.rounds
        return [(f"round 1 of {k}", self.first),
                (f"round {k} of {k}", self.last)]


def nbr_take(state, nbrt):
    """state[w] for each entry w of nbrt, the SENTINEL slots clipped."""
    return state[nbrt.long().clamp(max=state.shape[0] - 1)]


def bucket_bytes(ids, nbrt, colors, own, entry, stop=None, live=None,
                 writes=4) -> int:
    """The bytes a bucket launch's function needs. Every row: its id, its
    own color and `writes` bytes of output (int, or int64[Vt] a row). Each
    live row (by default the uncolored ones) also `own` bytes (int or
    int64[Vt]) and, over its row in order, `entry` bytes an entry
    (int64[Vt, Dt]: the index word and the neighbour's state words the
    function needs there, 0 where their condition fails) up to and
    including the first entry where `stop` holds (the row's answer is known
    there), else to the end of the row and its SENTINEL where Dt has room."""
    from gms_tpu_torch.graphs.tiles import SENTINEL
    n = colors.shape[0] - 1
    idl = ids.long()
    if live is None:
        live = (colors[idl] == -1) & (idl < n)
    valid = nbrt != SENTINEL
    entry = torch.where(valid, entry, torch.zeros_like(entry))
    ended = torch.ones_like(live)
    if stop is not None:
        hit = (stop & valid).long()
        entry = torch.where(torch.cumsum(hit, 1) - hit == 0, entry,
                            torch.zeros_like(entry))
        ended = hit.sum(1) == 0
    term = 4 * (ended & (valid.sum(1) < nbrt.shape[1])).long()
    per_live = own + entry.sum(1) + term
    out = (writes * ids.numel() if isinstance(writes, int)
           else int(writes.sum()))
    return 8 * ids.numel() + out + int(per_live[live].sum())


def color_compare(timing, calls):
    """calls: [(label, kernel, plain, bytes, setup)]. setup (or None)
    restores the kernel's buffer before each run, untimed; each function
    runs once for the comparison. Returns compare()'s tuple (bytes bound
    every call)."""
    err, k_ms, p_ms, bound = 0, 0.0, 0.0, 0.0
    for label, kernel, plain, nbytes, setup in calls:
        if setup is not None:
            setup()
        got, want = kernel(), plain()
        diff = max_abs_err(got, want)
        kt = timing.ms(kernel, KERNEL_REPS, setup=setup)
        pt = timing.ms(plain, PLAIN_REPS)
        bt = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"    {label}: max_abs_err {diff}, kernel {kt:.4f} ms, bound "
              f"{bt:.4f} ms ({nbytes} bytes), plain {pt:.4f} ms")
        err, k_ms, p_ms, bound = (max(err, diff), k_ms + kt, p_ms + pt,
                                  bound + bt)
    return err, k_ms, p_ms, bound, "bytes"


def jp_bucket_bytes(col, prio, ids, nbrt) -> int:
    """The bytes of a strict JP bucket from round-start colors col: for an
    uncolored row, its priority; each entry's index word and color, and an
    uncolored neighbour's priority, up to the first rival (an uncolored
    neighbour of higher priority: the row loses); a write only for a row
    that wins (the colors are updated in place)."""
    from gms_tpu_torch.graphs.tiles import SENTINEL
    idl = ids.long()
    unc_n = nbr_take(col, nbrt) == -1
    rival = unc_n & (nbr_take(prio, nbrt) > prio[idl][:, None])
    live = (col[idl] == -1) & (idl < col.shape[0] - 1)
    wins = live & ~(rival & (nbrt != SENTINEL)).any(1)
    return bucket_bytes(ids, nbrt, col, 4, 8 + 4 * unc_n.long(), stop=rival,
                        writes=4 * wins.long())


def jp_dispatch_bytes(gc, col, prio, tiers, limit: int, n: int):
    """(bytes, rounds) of a strict JP dispatch from col: each round's
    buckets as jp_bucket_bytes counts them from the round-start colors,
    summed over the rounds it runs (stepped a round at a time by jp_run)."""
    col, nbytes, r = col.clone(), 0, 0
    while r < limit and bool((col[:n] == -1).any()):
        nbytes += sum(jp_bucket_bytes(col, prio, ids, nbrt)
                      for ids, nbrt in tiers)
        gc.jp_run(col, prio, tiers, limit=1, n=n)
        r += 1
    return nbytes, r


def jp_calls(gc, label, state):
    """color_jp on each bucket of a strict JP round-start state; bytes by
    jp_bucket_bytes."""
    col, prio, tiers = state[:3]
    calls = []
    for ids, nbrt in tiers:
        nbytes = jp_bucket_bytes(col, prio, ids, nbrt)
        kbuf, pbuf = col.clone(), col.clone()

        def plain(ids=ids, nbrt=nbrt, pbuf=pbuf):
            pbuf.copy_(col)
            return gc.jp_bucket_plain(pbuf, prio, ids, nbrt)

        calls.append((
            f"color_jp {label}, Dt {nbrt.shape[1]}, Vt {ids.numel()}",
            lambda ids=ids, nbrt=nbrt, kbuf=kbuf: gc.jp_bucket(
                kbuf, prio, ids, nbrt),
            plain, nbytes, lambda kbuf=kbuf: kbuf.copy_(col)))
    return calls


def jp_run_calls(gc, label, state):
    """jp_run on a strict JP dispatch-start state (colors, priorities,
    tiers, its limit and n) against jp_run_plain, colors and rounds; bytes
    by jp_dispatch_bytes over the rounds it runs."""
    col, prio, tiers, kw = state
    nbytes, rounds = jp_dispatch_bytes(gc, col, prio, tiers, **kw)
    kbuf, pbuf = col.clone(), col.clone()

    def kernel():
        c, r = gc.jp_run(kbuf, prio, tiers, **kw)
        return c, r.long()

    def plain():
        pbuf.copy_(col)
        c, r = gc.jp_run_plain(pbuf, prio, tiers, **kw)
        return c, torch.tensor([r], device=c.device)

    return [(f"jp_run {label}, {rounds} rounds over {len(tiers)} buckets",
             kernel, plain, nbytes, lambda: kbuf.copy_(col))]


def spec_round_parts(gc, col, prio, tiers):
    """(pick0, tent, [(ids, nbrt, (pick, rank, clash bytes))]) of a
    speculative round-start state col: the passes' plain buffers, and each
    bucket's bytes of the three passes. Bytes, for an uncolored row: pick,
    each entry's index word and color; rank, its own pick and priority, each
    entry's index word and color, an uncolored neighbour's pick, and the
    priority of one whose pick is the row's; clash, its own tent and
    priority, each entry's index word and tent, and the priority of one
    whose tent is the row's, up to the first such neighbour of higher
    priority (the row loses)."""
    pick0 = col.clone()
    for ids, nbrt in tiers:
        gc.spec_pick_plain(col, ids, nbrt, pick0)
    tent = col.clone()
    for ids, nbrt in tiers:
        gc.spec_rank_plain(col, pick0, prio, ids, nbrt, tent)
    parts = []
    for ids, nbrt in tiers:
        idl = ids.long()
        unc_n = (nbr_take(col, nbrt) == -1).long()
        same_pk = (nbr_take(pick0, nbrt) == pick0[idl][:, None]).long()
        same_t = nbr_take(tent, nbrt) == tent[idl][:, None]
        higher = nbr_take(prio, nbrt) > prio[idl][:, None]
        parts.append((ids, nbrt, (
            bucket_bytes(ids, nbrt, col, 0, torch.full_like(unc_n, 8)),
            bucket_bytes(ids, nbrt, col, 8,
                         8 + 4 * unc_n + 4 * unc_n * same_pk),
            bucket_bytes(ids, nbrt, col, 8, 8 + 4 * same_t.long(),
                         stop=same_t & higher))))
    return pick0, tent, parts


def spec_calls(gc, label, state):
    """The three passes on each bucket of a speculative round-start state
    (spec_pick, spec_rank, spec_clash: no entry point runs them one by one);
    bytes by spec_round_parts."""
    col, prio, tiers = state[:3]
    pick0, tent, parts = spec_round_parts(gc, col, prio, tiers)
    calls = []
    for ids, nbrt, (b_pick, b_rank, b_clash) in parts:
        tag = f"{label}, Dt {nbrt.shape[1]}, Vt {ids.numel()}"
        bufs = [col.clone() for _ in range(6)]
        calls += [
            (f"spec_pick {tag}",
             lambda ids=ids, nbrt=nbrt, b=bufs[0]: gc.spec_pick(
                 col, ids, nbrt, b),
             lambda ids=ids, nbrt=nbrt, b=bufs[1]: gc.spec_pick_plain(
                 col, ids, nbrt, b), b_pick, None),
            (f"spec_rank {tag}",
             lambda ids=ids, nbrt=nbrt, b=bufs[2]: gc.spec_rank(
                 col, pick0, prio, ids, nbrt, b),
             lambda ids=ids, nbrt=nbrt, b=bufs[3]: gc.spec_rank_plain(
                 col, pick0, prio, ids, nbrt, b), b_rank, None),
            (f"spec_clash {tag}",
             lambda ids=ids, nbrt=nbrt, b=bufs[4]: gc.spec_clash(
                 col, tent, prio, ids, nbrt, b),
             lambda ids=ids, nbrt=nbrt, b=bufs[5]: gc.spec_clash_plain(
                 col, tent, prio, ids, nbrt, b), b_clash, None)]
    return calls


def spec_dispatch_bytes(gc, col, prio, tiers, limit: int, n: int):
    """(bytes, rounds) of a speculative dispatch from col: each round's
    buckets as spec_round_parts counts them from the round-start colors,
    summed over the rounds it runs."""
    nbytes, r = 0, 0
    while r < limit and bool((col[:n] == -1).any()):
        nbytes += sum(sum(b) for _, _, b in spec_round_parts(
            gc, col, prio, tiers)[2])
        col = gc.spec_round_plain(col, prio, tiers)
        r += 1
    return nbytes, r


def spec_run_calls(gc, label, state):
    """spec_run on a speculative dispatch-start state (colors, priorities,
    tiers, its limit and n) against spec_run_plain, colors and rounds;
    bytes by spec_dispatch_bytes over the rounds it runs."""
    col, prio, tiers, kw = state
    nbytes, rounds = spec_dispatch_bytes(gc, col, prio, tiers, **kw)
    kbuf, pbuf = col.clone(), col.clone()

    def kernel():
        c, r = gc.spec_run(kbuf, prio, tiers, **kw)
        return c, r.long()

    def plain():
        pbuf.copy_(col)
        c, r = gc.spec_run_plain(pbuf, prio, tiers, **kw)
        return c, torch.tensor([r], device=c.device)

    return [(f"spec_run {label}, {rounds} rounds over {len(tiers)} buckets",
             kernel, plain, nbytes, lambda: kbuf.copy_(col))]


def last_round_state(gc, run, state):
    """A dispatch-start state (colors, priorities, tiers, kw) stepped by
    the dispatch function `run` to the start of its last round: (label
    rounds, state)."""
    col = state[0].clone()
    _, rounds = run(col.clone(), *state[1:3], **state[3])
    if int(rounds) > 1:
        run(col, *state[1:3], limit=int(rounds) - 1, n=state[3]["n"])
    return int(rounds), (col,) + tuple(state[1:])


def johansson_bytes(col, deg1, draws, ids, nbrt) -> int:
    """A Johansson bucket's bytes, for an uncolored row: its draw and deg1;
    each entry's index word and color, and an uncolored neighbour's draw
    and deg1, up to the first neighbour whose pick is the row's."""
    idl = ids.long()
    ncol = nbr_take(col, nbrt)
    npick = torch.where(ncol == -1, torch.remainder(
        nbr_take(draws, nbrt), nbr_take(deg1, nbrt)), ncol)
    vpick = torch.remainder(draws[idl], deg1[idl])
    return bucket_bytes(ids, nbrt, col, 8, 8 + 8 * (ncol == -1).long(),
                        stop=npick == vpick[:, None])


def johansson_calls(gc, label, state):
    """johansson_bucket on each bucket of a Johansson round-start state,
    with that round's draws (bytes by johansson_bytes)."""
    col, deg1, draws, tiers = state[:4]
    calls = []
    for ids, nbrt in tiers:
        kb, pb = col.clone(), col.clone()
        calls.append((
            f"johansson_bucket {label}, Dt {nbrt.shape[1]}, Vt "
            f"{ids.numel()}",
            lambda ids=ids, nbrt=nbrt, b=kb: gc.johansson_bucket(
                col, deg1, draws, ids, nbrt, b),
            lambda ids=ids, nbrt=nbrt, b=pb: gc.johansson_bucket_plain(
                col, deg1, draws, ids, nbrt, b),
            johansson_bytes(col, deg1, draws, ids, nbrt), None))
    return calls


def johansson_round_calls(gc, label, state):
    """johansson_round (K24's round over every bucket) on a Johansson
    round-start state, with that round's draws, against
    johansson_round_plain; bytes every bucket's, as johansson_bytes."""
    col, deg1, draws, tiers = state[:4]
    return [(f"johansson_round {label}, {len(tiers)} buckets",
             lambda: gc.johansson_round(col, deg1, draws, tiers),
             lambda: gc.johansson_round_plain(col, deg1, draws, tiers),
             sum(johansson_bytes(col, deg1, draws, ids, nbrt)
                 for ids, nbrt in tiers), None)]


def one_shot_parts(gc, state):
    """(pick, nfree, [(ids, nbrt, pick bytes, resolve bytes)]) of a
    Barenboim or Elkin round-start state: the pick pass's plain buffers and
    each bucket's bytes. Pick, for an uncolored row: its two 64-bit draw
    words (and its deg1 for Elkin's palette), each entry's index word and
    color, two writes a row (pick and nfree); resolve, its nfree, and where
    nfree > 0 its pick and, over the entries w > v only, the index word,
    the color and an uncolored neighbour's pick, up to the first uncolored
    w > v with the row's pick."""
    col, deg1, draws, tiers, kw = state
    pick, nfree = col.clone(), torch.zeros_like(col)
    for ids, nbrt in tiers:
        gc.one_shot_pick_plain(col, deg1, draws, ids, nbrt, pick, nfree, **kw)
    parts = []
    for ids, nbrt in tiers:
        idl = ids.long()
        unc_v = (col[idl] == -1) & (idl < col.shape[0] - 1)
        unc_n = (nbr_take(col, nbrt) == -1).long()
        above = (nbrt.long() > idl[:, None]).long()
        free = nfree[idl] > 0
        clash = (above * unc_n).bool() & (nbr_take(pick, nbrt)
                                          == pick[idl][:, None])
        parts.append((
            ids, nbrt,
            bucket_bytes(ids, nbrt, col, 20 if kw["palette_deg"] else 16,
                         torch.full_like(unc_n, 8), writes=8),
            bucket_bytes(ids, nbrt, col, 8, above * (8 + 4 * unc_n),
                         stop=clash, live=unc_v & free)
            + 4 * int((unc_v & ~free).sum())))
    return pick, nfree, parts


def one_shot_calls(gc, label, state):
    """one_shot_pick and one_shot_resolve on each bucket of a Barenboim or
    Elkin round-start state, with that round's draws (bytes by
    one_shot_parts)."""
    col, deg1, draws, tiers, kw = state
    pick, nfree, parts = one_shot_parts(gc, state)
    calls = []
    for ids, nbrt, b_pick, b_resolve in parts:
        tag = f"{label}, Dt {nbrt.shape[1]}, Vt {ids.numel()}"
        kp, kn, pp, pn = col.clone(), col.clone(), col.clone(), col.clone()
        ko, po = col.clone(), col.clone()
        calls += [
            (f"one_shot_pick {tag}",
             lambda ids=ids, nbrt=nbrt, a=kp, b=kn: gc.one_shot_pick(
                 col, deg1, draws, ids, nbrt, a, b, **kw),
             lambda ids=ids, nbrt=nbrt, a=pp, b=pn: gc.one_shot_pick_plain(
                 col, deg1, draws, ids, nbrt, a, b, **kw), b_pick, None),
            (f"one_shot_resolve {tag}",
             lambda ids=ids, nbrt=nbrt, b=ko: gc.one_shot_resolve(
                 col, pick, nfree, ids, nbrt, b),
             lambda ids=ids, nbrt=nbrt, b=po: gc.one_shot_resolve_plain(
                 col, pick, nfree, ids, nbrt, b), b_resolve, None)]
    return calls


def one_shot_round_calls(gc, label, state):
    """one_shot_round (K24's pick and resolve passes over every bucket) on
    a Barenboim or Elkin round-start state, with that round's draws, against
    one_shot_round_plain (colors and nfree); bytes every bucket's, as
    one_shot_parts."""
    col, deg1, draws, tiers, kw = state
    nbytes = sum(b + c for *_, b, c in one_shot_parts(gc, state)[2])
    return [(f"one_shot_round {label}, {len(tiers)} buckets",
             lambda: gc.one_shot_round(col, deg1, draws, tiers, **kw),
             lambda: gc.one_shot_round_plain(col, deg1, draws, tiers, **kw),
             nbytes, None)]


def component_calls(gc, label, state):
    """K25 on a recorded step: its call's row schedule (the recorded
    keyword) given, as the main path gives it. Bytes: indptr and indices
    once, comp read once (every friend's label is a word of it), nxt and
    the changed word written."""
    indptr, indices, comp, kw = state
    n, nnz = comp.numel(), indices.numel()
    return [(f"color_components {label}, n {n}, {nnz} friend entries",
             lambda: gc.component_step(indptr, indices, comp, **kw),
             lambda: gc.component_step_plain(indptr, indices, comp),
             8 * (n + 1) + 4 * nnz + 8 * n + 4, None)]


def coloring_phases(timing, report) -> None:
    """Phases 37-41: graph coloring (see the module docstring)."""
    from gms_tpu_torch.bench.profiling import profile_window, window_lines
    from gms_tpu_torch.algorithms import coloring as gc
    from gms_tpu_torch.algorithms import similarity as vs
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el

    t0 = time.perf_counter()
    g = build_csr(generate_rmat_el(COLOR_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << COLOR_SCALE)
    deg = g.degrees
    buckets = [(ids.size, t.shape[1]) for ids, t in gc._TierGraph(g).tiers]
    print(f"[37] graph RMAT {COLOR_SCALE}: {g.num_nodes} nodes "
          f"({int((deg == 0).sum())} isolated), {g.num_edges_undirected} "
          f"undirected edges, max degree {g.max_degree}; buckets (vertices, "
          f"width) {buckets}; {time.perf_counter() - t0:.2f} s")

    def held(graph, c, want_n, want_d, what):
        n_col, d = gc.unique_colors_count(c), color_digest(c)
        check(gc.verify_coloring(graph, c), f"{what}: not a proper coloring")
        if want_n is not None:
            check((n_col, d) == (want_n, want_d),
                  f"{what}: {n_col} colors, digest {d}; want {want_n}, "
                  f"{want_d}")
        return n_col, d

    # [37] main path: speculative JP-LF, counters from 0
    kw, want_n, want_d = COLOR_GOLDEN["spec-lf"]
    gc.reset_launches()
    t0 = time.perf_counter()
    with RoundStates(gc, "spec_run", every=True) as spec_states:
        c = gc.jones_plassmann(g, device="cuda", **kw)
    first_s = time.perf_counter() - t0
    main_launches = dict(gc.LAUNCHES)
    rounds = gc.ROUNDS["jones_plassmann"]
    spec_dispatches = spec_states.rounds
    n_col, d = held(g, c, want_n, want_d, "speculative JP-LF")
    check(gc.verify_degree_bound(g, c), "speculative JP-LF over deg(v)")
    warm = []
    for _ in range(COLOR_WARM):
        t0 = time.perf_counter()
        c = gc.jones_plassmann(g, device="cuda", **kw)
        warm.append(time.perf_counter() - t0)
        check(color_digest(c) == want_d, "a warm call's colors differ")
    tier_s = []
    for _ in range(COLOR_WARM):
        t0 = time.perf_counter()
        gc._TierGraph(g).to("cuda")
        torch.cuda.synchronize()
        tier_s.append(time.perf_counter() - t0)
    print(f"[37] main path jones_plassmann(g, speculative=True, "
          f"priority=\"degree\"): {n_col} colors, digest {d}; first call "
          f"(round states recorded) {first_s:.4f} s, median of {COLOR_WARM} warm calls "
          f"{statistics.median(warm):.4f} s, of which the host tier build "
          f"and its copy {statistics.median(tier_s):.4f} s (median of "
          f"{COLOR_WARM} apart); {rounds} rounds in {spec_dispatches} "
          f"dispatch(es); launches {main_launches}")
    check(main_launches["spec_run"] == spec_dispatches > 0,
          f"K23 (spec_run) launched {main_launches['spec_run']} times over "
          f"{spec_dispatches} speculative dispatches")
    gc.reset_launches()
    c, host_s, per, busy = profile_window(
        lambda: gc.jones_plassmann(g, device="cuda", **kw))
    check(color_digest(c) == want_d, "the profiled speculative call's colors")
    spec_sums = window_lines(
        "[37] warm speculative JP-LF call under torch.profiler:", host_s, per,
        busy, {"K23": ("spec_run_kernel",)})
    check(gc.LAUNCHES["spec_run"] == spec_dispatches,
          f"the profiled call launched K23 {gc.LAUNCHES['spec_run']} times "
          f"over {spec_dispatches} dispatches")
    whole_b, whole_r = 0, 0
    for col, prio, tiers, dkw in spec_states.every:
        b, r = spec_dispatch_bytes(gc, col, prio, tiers, **dkw)
        whole_b, whole_r = whole_b + b, whole_r + r
    check(whole_r == rounds, f"the speculative dispatches replayed {whole_r} "
          f"rounds, the call ran {rounds}")
    print(f"    [37] its {spec_dispatches} dispatch(es), {whole_r} rounds: "
          f"bound {whole_b / HBM_BYTES_PER_S * 1e3:.4f} ms ({whole_b} bytes)"
          f" against K23's {spec_sums['K23'][0]:.4f} ms of device time | "
          f"{card_line()}")

    # [38] the other deterministic variants, counters from 0 before each
    run_launches = {}
    strict_states = RoundStates(gc, "jp_run", every=True)
    for key in ("spec-random", "strict-lf", "strict-random"):
        kw, want_n, want_d = COLOR_GOLDEN[key]
        gc.reset_launches()
        t0 = time.perf_counter()
        with (strict_states if key == "strict-lf"
              else contextlib.nullcontext()):
            c = gc.jones_plassmann(g, device="cuda", **kw)
        dt = time.perf_counter() - t0
        run_launches[key] = dict(gc.LAUNCHES)
        n_col, d = held(g, c, want_n, want_d, key)
        print(f"[38] JP {key}: {n_col} colors, digest {d}, "
              f"{gc.ROUNDS['jones_plassmann']} rounds, {dt:.4f} s; launches "
              f"{run_launches[key]}")
    dispatches = strict_states.rounds
    check(run_launches["strict-lf"]["jp_run"] == dispatches > 0,
          f"K22 (jp_run) launched {run_launches['strict-lf']['jp_run']} "
          f"times over {dispatches} strict JP-LF dispatches")
    kw, _, want_d = COLOR_GOLDEN["strict-lf"]
    gc.reset_launches()
    c, host_s, per, busy = profile_window(
        lambda: gc.jones_plassmann(g, device="cuda", **kw))
    check(color_digest(c) == want_d, "the profiled strict JP-LF call's colors")
    sums = window_lines("[38] warm strict JP-LF call under torch.profiler:",
                        host_s, per, busy,
                        {"K22": ("jp_run_kernel", "jp_decide", "jp_commit")})
    check(gc.LAUNCHES["jp_run"] == dispatches,
          f"the profiled call launched K22 {gc.LAUNCHES['jp_run']} times "
          f"over {dispatches} dispatches")
    # the whole call's bound: every dispatch's rounds, each round's buckets
    # as phase 41 counts them
    strict_b, strict_r = 0, 0
    for col, prio, tiers, dkw in strict_states.every:
        b, r = jp_dispatch_bytes(gc, col, prio, tiers, **dkw)
        strict_b, strict_r = strict_b + b, strict_r + r
    check(strict_r == gc.ROUNDS["jones_plassmann"],
          f"the dispatches replayed {strict_r} rounds, the call ran "
          f"{gc.ROUNDS['jones_plassmann']}")
    print(f"    [38] its {dispatches} dispatches, {strict_r} rounds: bound "
          f"{strict_b / HBM_BYTES_PER_S * 1e3:.4f} ms ({strict_b} bytes) "
          f"against K22's {sums['K22'][0]:.4f} ms of device time | "
          f"{card_line()}")
    gc.reset_launches()
    vs.reset_launches()
    t0 = time.perf_counter()
    c = gc.dense_sparse(g, seed=0, device="cuda")
    dt = time.perf_counter() - t0
    n_col, d = held(g, c, *COLOR_DS_GOLDEN[0], "dense_sparse RMAT 16")
    print(f"[38] dense_sparse(g, seed=0): {n_col} colors, digest {d}, "
          f"{gc.ROUNDS['dense_sparse']} JP rounds, {dt:.4f} s; launches "
          f"{dict(gc.LAUNCHES)}, pair_scores {vs.LAUNCHES['pair_scores']}")
    check(gc.LAUNCHES["jp_run"] > 0, "dense_sparse: K22 never launched")

    # [39] dense_sparse with its friend components firing
    g14 = build_csr(generate_rmat_el(COLOR_DS_SCALE, DEGREE, seed=SEED),
                    num_nodes=1 << COLOR_DS_SCALE)
    gc.reset_launches()
    vs.reset_launches()
    t0 = time.perf_counter()
    with RoundStates(gc, "component_step", keep=(0,)) as ds_states, \
            RoundStates(vs, "pair_scores") as ds_pairs:
        c = gc.dense_sparse(g14, seed=0, friend_number=COLOR_DS_FRIENDS,
                            device="cuda")
    dt = time.perf_counter() - t0
    ds_launches = dict(gc.LAUNCHES)
    ds_k18 = vs.LAUNCHES["pair_scores"]
    n_col, d = held(g14, c, *COLOR_DS_GOLDEN[1], "dense_sparse RMAT 14")
    print(f"[39] dense_sparse(RMAT {COLOR_DS_SCALE}, friend_number="
          f"{COLOR_DS_FRIENDS}): {n_col} colors, digest {d}, "
          f"{gc.ROUNDS['component_labels']} label steps, "
          f"{gc.ROUNDS['dense_sparse']} JP rounds, {dt:.4f} s; launches "
          f"{ds_launches}, pair_scores {vs.LAUNCHES['pair_scores']}")
    check(ds_launches["color_components"] > 0, "K25 never launched")
    check(vs.LAUNCHES["pair_scores"] > 0, "K18 never launched")

    # [40] the randomized runs, counters from 0 before each
    rand_states, rand_launches = {}, {}
    for label, call, fn, bound in (
            ("johansson", lambda: gc.johansson(g, device="cuda"),
             "johansson_round", gc.verify_degree_bound),
            ("barenboim", lambda: gc.barenboim_elkin(
                g, variant="barenboim", device="cuda"), "one_shot_round",
             gc.verify_delta_plus_one),
            ("elkin", lambda: gc.barenboim_elkin(
                g, variant="elkin", device="cuda"), "one_shot_round",
             gc.verify_degree_bound)):
        gc.reset_launches()
        t0 = time.perf_counter()
        with RoundStates(gc, fn) as rand_states[label]:
            c = call()
        dt = time.perf_counter() - t0
        rand_launches[label] = dict(gc.LAUNCHES)
        n_col, _ = held(g, c, None, None, label)
        check(bound(g, c) and gc.verify_delta_plus_one(g, c),
              f"{label} breaks its color bound")
        print(f"[40] {label}: {n_col} colors, rounds "
              f"{rand_states[label].rounds}, {dt:.4f} s; launches "
              f"{rand_launches[label]}")
    # K24's launches a round: Johansson's pick words and round, the
    # one-shot's pick and resolve
    per_round = {"color_johansson": 2, "color_one_shot": 2}
    for label, key in (("johansson", "color_johansson"),
                       ("barenboim", "color_one_shot"),
                       ("elkin", "color_one_shot")):
        got, rounds = rand_launches[label][key], rand_states[label].rounds
        check(got == per_round[key] * rounds > 0,
              f"K24 ({key}) launched {got} times over {label}'s {rounds} "
              f"rounds, not {per_round[key]} a round")
    # gms_tpu's colors at RMAT 14 (its keys, jax.random's draws)
    for label, (want_n, want_d) in COLOR_RANDOM_GOLDEN.items():
        t0 = time.perf_counter()
        c = (gc.johansson(g14, device="cuda") if label == "johansson"
             else gc.barenboim_elkin(g14, variant=label, device="cuda"))
        dt = time.perf_counter() - t0
        n_col, d = held(g14, c, want_n, want_d, f"{label} RMAT 14")
        print(f"[40] {label} RMAT {COLOR_DS_SCALE}: {n_col} colors, digest "
              f"{d} = gms_tpu's, {dt:.4f} s")
    check(all(rand_launches[v]["color_one_shot"] > 0
              for v in ("barenboim", "elkin")), "K24's one-shot never launched")

    # [41] each kernel against its plain version on the recorded round-start
    # states (the round's own draws for K24): the first round and the last
    # with an uncolored vertex, every bucket. Each kernels-line entry takes
    # its launches and its times from one run. K22: jp_run, which strict JP
    # runs, on strict JP-LF's first and last dispatch; jp_bucket (one
    # bucket, jp_run's decide and a commit pass), which no entry point runs
    # now, held off the kernels line on the first round and the last
    dfirst, dlast = strict_states.first, strict_states.last
    _, last_round = last_round_state(gc, gc.jp_run, dlast)
    strict_rounds = [(f"round 1 of {strict_r}", dfirst),
                     (f"round {strict_r} of {strict_r}", last_round)]
    err, k_ms, p_ms, bound_ms, _ = color_compare(timing, [
        c for lab, st in strict_rounds
        for c in jp_calls(gc, f"JP-LF {lab}", st)])
    print(f"[41] color_jp (jp_bucket, off the main path) on strict JP-LF's "
          f"first and last round: max_abs_err {err}, kernel {k_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms (bytes), plain {p_ms:.4f} ms")
    check(err == 0, f"color_jp disagrees with its plain version by {err}")
    # K23's three passes, one bucket a launch (no entry point runs them so),
    # off the kernels line on the speculative main path's first and last
    # round (its last dispatch stepped to its last round by spec_run)
    sfirst, slast = spec_states.first, spec_states.last
    _, spec_last = last_round_state(gc, gc.spec_run, slast)
    err, k_ms, p_ms, bound_ms, _ = color_compare(timing, [
        c for lab, st in ((f"round 1 of {rounds}", sfirst),
                          (f"round {rounds} of {rounds}", spec_last))
        for c in spec_calls(gc, f"spec JP-LF {lab}", st)])
    print(f"[41] spec_pick, spec_rank, spec_clash (off the main path) on the "
          f"speculative JP-LF call's first and last round: max_abs_err {err}"
          f", kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), plain "
          f"{p_ms:.4f} ms")
    check(err == 0, f"K23's passes disagree with their plain versions by "
          f"{err}")
    spec_held = [(f"dispatch 1 of {spec_dispatches}", sfirst)]
    if spec_dispatches > 1:
        spec_held.append((f"dispatch {spec_dispatches} of {spec_dispatches}",
                          slast))
    groups = {
        "jp_run": (run_launches["strict-lf"], [
            c for lab, st in ((f"dispatch 1 of {dispatches}", dfirst),
                              (f"dispatch {dispatches} of {dispatches}",
                               dlast))
            for c in jp_run_calls(gc, f"JP-LF {lab}", st)]),
        "spec_run": (main_launches, [
            c for lab, st in spec_held
            for c in spec_run_calls(gc, f"spec JP-LF {lab}", st)]),
        "color_johansson": (rand_launches["johansson"], [
            c for lab, st in rand_states["johansson"].both()
            for c in johansson_round_calls(gc, f"Johansson {lab}", st)]),
        "color_one_shot": (rand_launches["barenboim"], [
            c for lab, st in rand_states["barenboim"].both()
            for c in one_shot_round_calls(gc, f"Barenboim {lab}", st)]),
        "color_components": (ds_launches, [
            c for lab, st in ds_states.both()
            for c in component_calls(gc, f"RMAT {COLOR_DS_SCALE}, label "
                                     f"step {lab.split()[1]}", st)]),
    }
    # K18 on dense_sparse's RMAT 14 friend counts (its first and last
    # launch; K18's kernels-line entry is phase 35's): bytes, the pairs,
    # their ends' deg1 entries, each distinct row to its first SENTINEL and
    # the output
    k18 = []
    for lab, (nbr, deg1, pairs, kw) in ds_pairs.both():
        ends = torch.unique(pairs.reshape(-1))
        k18.append((
            f"pair_scores dense_sparse RMAT {COLOR_DS_SCALE} launch "
            f"{lab.split()[1]}, {pairs.shape[0]} pairs",
            lambda nbr=nbr, deg1=deg1, pairs=pairs, kw=kw: vs.pair_scores(
                nbr, deg1, pairs, **kw),
            lambda nbr=nbr, deg1=deg1, pairs=pairs, kw=kw:
                vs.pair_scores_plain(nbr, deg1, pairs, **kw),
            (pairs.numel() + ends.numel() + distinct_data_words(
                deg1[:-1], [(pairs[:, 0], nbr.shape[1]),
                            (pairs[:, 1], nbr.shape[1])])
             + pairs.shape[0]) * 4))
    err, k_ms, p_ms, bound_ms, by = compare(timing, k18, err_fn=score_err)
    print(f"[41] pair_scores (K18) on dense_sparse's friend counts, first "
          f"and last of its {ds_k18} launches: max_abs_err {err}, kernel "
          f"{k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain {p_ms:.4f} "
          f"ms | {card_line()}")
    check(err == 0, f"K18 (dense_sparse) disagrees with plain by {err}")
    # Elkin's per-vertex palettes: held to plain too, not on the kernels line
    err, k_ms, p_ms, bound_ms, _ = color_compare(timing, [
        c for lab, st in rand_states["elkin"].both()
        for c in one_shot_round_calls(gc, f"Elkin {lab}", st)])
    print(f"[41] color_one_shot (one_shot_round) on Elkin's first and last "
          f"round: max_abs_err {err}, kernel {k_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms (bytes), plain {p_ms:.4f} ms; its launches "
          f"{rand_launches['elkin']['color_one_shot']}")
    check(err == 0, f"color_one_shot (Elkin) disagrees with plain by {err}")
    # K24's one-bucket entries, which no entry point runs: off the kernels
    # line, on Johansson's and Barenboim's first and last round
    err, k_ms, p_ms, bound_ms, _ = color_compare(timing, [
        c for lab, st in rand_states["johansson"].both()
        for c in johansson_calls(gc, f"Johansson {lab}", st)] + [
        c for lab, st in rand_states["barenboim"].both()
        for c in one_shot_calls(gc, f"Barenboim {lab}", st)])
    print(f"[41] johansson_bucket, one_shot_pick, one_shot_resolve (off the "
          f"main path) on Johansson's and Barenboim's first and last round: "
          f"max_abs_err {err}, kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"(bytes), plain {p_ms:.4f} ms")
    check(err == 0, f"K24's one-bucket entries disagree with their plain "
          f"versions by {err}")
    for name, (launches, calls) in groups.items():
        err, k_ms, p_ms, bound_ms, by = color_compare(timing, calls)
        lib_ms = None
        if name == "color_components":
            # one scatter_reduce_ (amin) over the friend edge list computes
            # the same step; on the same two states as the kernel
            lib_ms = 0.0
            for lab, (indptr, indices, comp, kw) in ds_states.both():
                rows = torch.repeat_interleave(
                    torch.arange(comp.numel(), device="cuda"),
                    indptr[1:] - indptr[:-1])

                def lib(comp=comp, rows=rows, idx=indices.long()):
                    return comp.clone().scatter_reduce_(0, rows, comp[idx],
                                                        reduce="amin")

                def k25(indptr=indptr, indices=indices, comp=comp, kw=kw):
                    return gc.component_step(indptr, indices, comp, **kw)

                check(torch.equal(lib(), k25()[0]),
                      "scatter_reduce_ differs from K25")
                lib_ms += timing.ms(lib, KERNEL_REPS)
                sched, build = schedule_build(indptr)
                k_us, k_per = device_us(k25)
                l_us, l_per = device_us(lib)
                print(f"    {lab}: batched ({BATCH_STEPS} back-to-back steps "
                      f"after one flush) K25 {batched_ms(timing, k25):.4f} "
                      f"ms a step, scatter_reduce_ "
                      f"{batched_ms(timing, lib):.4f} ms a step; device µs "
                      f"a step (torch.profiler, {BATCH_STEPS} steps) K25 "
                      f"{k_us} {k_per}, scatter_reduce_ {l_us} {l_per}; its "
                      f"row schedule ({sched.n_narrow} narrow rows, "
                      f"{sched.n_seg} segments, {sched.n_wide} wide rows) "
                      f"built in {build:.4f} ms (host clock, synchronised)")
            print(f"    library scatter_reduce_ (amin) on both steps "
                  f"{lib_ms:.4f} ms; the Timing floor (a 4-byte fill) "
                  f"{floor_ms(timing):.4f} ms | {card_line()}")
        print(f"[41] {name}: {len(calls)} launches held, max_abs_err {err}, "
              f"kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
              f"{p_ms:.4f} ms; launches of its run {launches[name]}")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        report.append(kernel_entry(name, launches[name], err, k_ms, p_ms,
                                   bound_ms, by, library_ms=lib_ms))

# ---------------------------------------------------------------------------
# phases 42-46: subgraph isomorphism (VF2) and the compressed graph layer
# ---------------------------------------------------------------------------

class LevelStates:
    """Records a VF2 run's level inputs: inside the `with` block the module's
    `feasible` is wrapped to keep its arguments (by reference: a level's
    inputs are never written after the call). Keeps the first and the
    last."""

    def __init__(self, si):
        self.si = si
        self.first = self.last = None
        self.levels = 0

    def __enter__(self):
        inner = self.inner = self.si.feasible

        def record(*args, **kw):
            if self.first is None:
                self.first = (args, kw)
            self.last = (args, kw)
            self.levels += 1
            return inner(*args, **kw)

        self.si.feasible = record
        return self

    def __exit__(self, *exc):
        self.si.feasible = self.inner

    def both(self, label):
        k = self.levels
        return [(f"{label} level 1 of {k}", self.first),
                (f"{label} level {k} of {k}", self.last)]


def verify_rows(si, g, pattern, rows, induced) -> bool:
    """si.verify_mapping for each row, on the subgraph of g induced by the
    row's vertices (relabelled 0..P-1 in row order, mapped by the identity):
    it has an edge (a, b) exactly where g has (row[a], row[b]), so the check
    is the same as on g, without verify_mapping's V sets a call."""
    from gms_tpu_torch.graphs.csr import _csr_from_sorted_pairs

    P = pattern.num_nodes
    for row in np.asarray(rows, dtype=np.int64):
        if len(set(row.tolist())) != P:
            return False
        el = []  # (a, b) ascending, both directions: already CSR order
        for a in range(P):
            r = g.out_neigh(int(row[a]))
            for b in range(P):
                i = np.searchsorted(r, row[b])
                if a != b and i < len(r) and r[i] == row[b]:
                    el.append((a, b))
        sub = _csr_from_sorted_pairs(
            np.array(el, dtype=np.int64).reshape(-1, 2), P, directed=False)
        if not si.verify_mapping(sub, pattern, np.arange(P), induced=induced):
            return False
    return True


def distinct_rows_count(rows) -> int:
    """Distinct rows of an int32[n, P] array of ids below 2^15 (P <= 4),
    each row one int64 key, counted by torch.unique on the card."""
    key = torch.zeros(len(rows), dtype=torch.int64, device="cuda")
    for j in range(rows.shape[1]):
        col = torch.from_numpy(np.ascontiguousarray(rows[:, j])).to("cuda")
        key = (key << 16) | col.long()
    return int(torch.unique(key).numel())


def feasible_bytes(si, args, kw) -> int:
    """Bytes K26 must move for one level: M and the candidates read, ok
    written and the count; the deg1 entries of the live candidates and, in
    gms_tpu's order of checks, the bitmap words or padded-row words (the
    binary search's probes) each check consults for the candidates still
    alive at it, each distinct word once."""
    from gms_tpu_torch.graphs.tiles import SENTINEL

    M, cand, nbr, deg1, bmp, pdeg = args
    d = kw["d"]
    use_bmp = bmp.shape[0] > 1
    nbytes = 4 * M.numel() + 5 * cand.numel() + 8
    alive = (cand != int(SENTINEL)) & (M[:, :1] >= 0)
    nbytes += 4 * int(torch.unique(cand[alive]).numel())
    alive &= deg1[cand.long().clamp(0, deg1.numel() - 1)] >= pdeg
    for j in range(d):
        alive &= cand != M[:, j:j + 1]
    checks = [(p, True) for p in kw["parents"]]
    if kw["induced"]:
        checks += [(p, False) for p in kw["nonparents"]]
    words = []
    for p, want in checks:
        n, i = alive.nonzero(as_tuple=True)
        a, c = M[n, p].long(), cand[n, i].long()
        if use_bmp:
            V, vw = bmp.shape
            q = c.clamp(0, 32 * vw - 1)
            w = a.clamp(0, V - 1) * vw + (q >> 5)
            words.append(w)
            hit = ((bmp.reshape(-1)[w].long() >> (q & 31)) & 1) == 1
        else:
            width = nbr.shape[1]
            base = a.clamp(0, nbr.shape[0] - 1) * width
            flat = nbr.reshape(-1)
            lo = torch.zeros_like(c)
            hi = torch.full_like(c, width)
            while bool((lo < hi).any()):
                live = lo < hi
                mid = (lo + hi) >> 1
                words.append((base + mid)[live])
                less = flat[base + mid.clamp(max=width - 1)].long() < c
                lo = torch.where(live & less, mid + 1, lo)
                hi = torch.where(live & ~less, mid, hi)
            idx = lo.clamp(max=width - 1)
            words.append(base + idx)
            hit = flat[base + idx].long() == c
        alive[n, i] = hit == want
    if words:
        nbytes += 4 * int(torch.unique(torch.cat(words)).numel())
    return nbytes


def emit_bytes(M, ok, cap: int) -> int:
    """Bytes K27 must move: ok read, each emitted child's M row (each item
    once) and candidate, the cap x P output and n_out written."""
    n = ok.nonzero(as_tuple=True)[0][:cap]
    items = int(torch.unique(n).numel())
    return ok.numel() + 4 * (items * M.shape[1] + n.numel()
                             + cap * M.shape[1]) + 8


def kbit_bytes(deg, vids, k: int, d_pad: int) -> int:
    """Bytes K28 must move: each distinct row's packed words up to its last
    live lane, its deg entry, vids read and the output written."""
    v = torch.unique(vids.long().clamp(0, deg.numel() - 1))
    words = (deg[v].long() * k + 31) // 32
    return 4 * (int(words.sum()) + v.numel() + vids.numel()
                + vids.numel() * d_pad)


def vf2_compare(si, label, states):
    """K26 and K27 against their plain versions on recorded level inputs:
    (feasible calls, emit calls) for compare()."""
    from gms_tpu_torch.algorithms.k_clique import _bucket

    fcalls, ecalls = [], []
    for lab, (args, kw) in states:
        M, cand = args[0], args[1]
        fcalls.append((f"K26 {label} {lab}: N={M.shape[0]} Dc={cand.shape[1]}",
                       lambda a=args, k=kw: si.feasible(*a, **k),
                       lambda a=args, k=kw: si.feasible_plain(*a, **k),
                       feasible_bytes(si, args, kw)))
        ok, count = si.feasible(*args, **kw)
        cap = _bucket(int(count))
        ecalls.append((f"K27 {label} {lab}: {int(count)} children, cap {cap}",
                       lambda M=M, c=cand, ok=ok, d=kw["d"], cap=cap:
                       si.emit(M, c, ok, d=d, cap=cap),
                       lambda M=M, c=cand, ok=ok, d=kw["d"], cap=cap:
                       si.emit_plain(M, c, ok, d=d, cap=cap),
                       emit_bytes(M, ok, cap)))
    return fcalls, ecalls


def vf2_phases(g14):
    """Phases 42-44: VF2 (see the module docstring). g14 is RMAT 14.
    Returns the main path's launches and the recorded level inputs of the
    two c5 device runs."""
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.algorithms import subgraph_iso as si
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el

    def pat(name):
        return build_csr(np.array(si.VF2_PATTERNS[name], dtype=np.int64))

    print(f"[42] graph RMAT {VF2_SCALE}: {g14.num_nodes} nodes, "
          f"{g14.num_edges_undirected} undirected edges, max degree "
          f"{g14.max_degree}")
    # [42] bench.py's vf2 round at RMAT 14: induced, limit=1, best of 3 warm
    recorded = {}
    for name in si.VF2_PATTERNS:
        p = pat(name)
        for mode, hb in (("hybrid", 200_000), ("device", 0)):
            si.reset_launches()
            main = name == "c5" and mode == "device"
            t0 = time.perf_counter()
            with (LevelStates(si) if main
                  else contextlib.nullcontext()) as states:
                res = si.subgraph_isomorphism(g14, p, induced=True, limit=1,
                                              host_budget=hb, device="cuda")
            first_s = time.perf_counter() - t0
            launches = dict(si.LAUNCHES)
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                again = si.subgraph_isomorphism(g14, p, induced=True,
                                                limit=1, host_budget=hb,
                                                device="cuda")
                ts.append(time.perf_counter() - t0)
                check(np.array_equal(again, res), f"vf2 {name} {mode}: a "
                      f"warm call's mapping differs")
            got = res.tolist()
            print(f"[42] vf2 {name} {mode}: {got}, best of 3 warm "
                  f"{min(ts):.4f} s (first {first_s:.4f} s); launches "
                  f"{launches}"
                  + (f", {states.levels} levels" if main else ""))
            check(got == [VF2_GOLDEN[name]], f"vf2 {name} {mode}: {got} != "
                  f"gms_tpu's {VF2_GOLDEN[name]}")
            check(verify_rows(si, g14, p, res, induced=True),
                  f"vf2 {name} {mode}: not an induced mapping")
            if mode == "hybrid":
                check(not any(si.LAUNCHES.values()),
                      f"hybrid vf2 {name} launched {dict(si.LAUNCHES)}")
            if main:
                recorded["main"] = (launches, states)
                check(all(n > 0 for n in launches.values()),
                      f"a VF2 kernel never launched: {launches}")

    # [43] the search branch: RMAT 17's id-space bitmap would take 2 GB
    t0 = time.perf_counter()
    g17 = build_csr(generate_rmat_el(VF2_SEARCH_SCALE, DEGREE, seed=SEED),
                    num_nodes=1 << VF2_SEARCH_SCALE)
    build_s = time.perf_counter() - t0
    si.reset_launches()
    t0 = time.perf_counter()
    with LevelStates(si) as states17:
        res = si.subgraph_isomorphism(g17, pat("c5"), induced=True, limit=1,
                                      host_budget=0, device="cuda")
    dt = time.perf_counter() - t0
    got = res.tolist()
    bmp = states17.first[0][4]
    print(f"[43] vf2 c5 device at RMAT {VF2_SEARCH_SCALE} ({g17.num_nodes} "
          f"nodes, max degree {g17.max_degree}, built in {build_s:.2f} s): "
          f"{got} in {dt:.4f} s (padded rows and all), {states17.levels} "
          f"levels, bitmap {tuple(bmp.shape)}; launches {dict(si.LAUNCHES)}")
    check(tuple(bmp.shape) == (1, 1), "RMAT 17 did not take the search branch")
    check(got == [VF2_SEARCH_GOLDEN], f"vf2 c5 RMAT {VF2_SEARCH_SCALE}: "
          f"{got} != gms_tpu's {VF2_SEARCH_GOLDEN}")
    check(verify_rows(si, g17, pat("c5"), res, induced=True),
          "vf2 c5 RMAT 17: not an induced mapping")
    recorded["search"] = states17
    del g17

    # [44] enumeration (limit=None, non-induced) against independent counts
    rng = np.random.default_rng(SEED)
    tri = build_csr(np.array([[0, 1], [1, 2], [0, 2]], dtype=np.int64))
    k4_scale = k4_count = None
    for s in (12, 11, 10):
        gk = build_csr(generate_rmat_el(s, DEGREE, seed=SEED), num_nodes=1 << s)
        k4_count = kc.kclique_count(gk, 4, device="cuda")
        if 24 * k4_count * 16 <= VF2_ENUM_BYTES:
            k4_scale = s
            break
    check(k4_scale is not None, "no RMAT 10-12 K4 enumeration fits 1 GB")
    for label, g, p, want in (
            (f"triangle RMAT {VF2_SCALE}", g14, tri, VF2_TRI_GOLDEN),
            (f"K4 RMAT {k4_scale}", gk, pat("k4"), 24 * k4_count)):
        t0 = time.perf_counter()
        rows = si.subgraph_isomorphism(g, p, limit=None, device="cuda")
        dt = time.perf_counter() - t0
        distinct = distinct_rows_count(rows)
        sample = rows[rng.choice(len(rows), VF2_SAMPLE, replace=False)]
        print(f"[44] enumerate {label}: {len(rows)} mappings ({distinct} "
              f"distinct), want {want}, {dt:.4f} s")
        check(len(rows) == want == distinct, f"enumerate {label}: "
              f"{len(rows)} rows, {distinct} distinct, want {want}")
        check(verify_rows(si, g, p, sample, induced=False),
              f"enumerate {label}: a sampled row is not a mapping")
        del rows
    return recorded


def compressed_phases(timing, report, g14, recorded):
    """Phases 45-46: the compressed layer at RMAT 14, then K26-K28 against
    their plain versions (see the module docstring)."""
    from gms_tpu_torch.algorithms import subgraph_iso as si
    from gms_tpu_torch.algorithms import triangle_count as tc
    from gms_tpu_torch.graphs import compressed as cp
    from gms_tpu_torch.graphs.tiles import PaddedGraph

    # [45] the three compressed forms: decode, triangle count, footprint
    cp.reset_launches()
    forms = {}
    for name, make in (("KbitGraph", cp.KbitGraph.from_csr),
                       ("KbitGraphBucketed", cp.KbitGraphBucketed.from_csr),
                       ("HybridGraph", cp.HybridGraph.from_csr)):
        t0 = time.perf_counter()
        rep = forms[name] = make(g14, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        csr = cp.as_csr(rep)
        dec_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        count = tc.triangle_count(rep, device="cuda")
        tc_s = time.perf_counter() - t0
        print(f"[45] {name} of RMAT {VF2_SCALE}: {rep.bits_per_edge():.4f} "
              f"bits/edge, host pack {build_s:.4f} s, as_csr {dec_s:.4f} s, "
              f"triangle_count {count} in {tc_s:.4f} s")
        check(csr == g14, f"as_csr({name}) differs from the CSR")
        check(count == KBIT_TRI_GOLDEN, f"triangle_count({name}) {count} != "
              f"{KBIT_TRI_GOLDEN}")
    kbit_launches = cp.LAUNCHES["kbit_decode_rows"]
    check(kbit_launches > 0, "K28 never launched")
    kg = forms["KbitGraph"]
    pg = PaddedGraph.from_csr(g14, device="cuda")
    check(torch.equal(kg.nbr, pg.nbr), "K28's rows differ from the padded rows")
    w = np.random.default_rng(SEED).integers(1, 256, g14.num_edges,
                                             dtype=np.int32)
    kw = cp.KbitWeightedGraph.from_csr(g14, w, device="cuda")
    deg = g14.degrees.astype(np.int64)
    wrows = np.zeros((pg.v_pad, pg.d_pad), dtype=np.int32)
    wrows[np.repeat(np.arange(g14.num_nodes), deg),
          np.arange(g14.num_edges) - np.repeat(g14.indptr[:-1], deg)] = w
    check(torch.equal(kw.weight_rows().cpu(), torch.from_numpy(wrows)),
          "KbitWeightedGraph.weight_rows differs from the weights")
    print(f"[45] K28 rows of RMAT {VF2_SCALE} (k={kg.k}, d_pad {kg.d_pad}) "
          f"equal PaddedGraph's; KbitWeightedGraph (kw={kw.kw}) "
          f"{kw.bits_per_edge():.4f} bits/edge, weight_rows equal; K28 "
          f"launches {kbit_launches}; padded int32 "
          f"{32 * pg.nbr.numel() / g14.num_edges:.4f} bits/edge")

    # [46] each kernel against its plain version, CUDA-event times, L2
    # flushed; K26 and K27 on the first and last level of both c5 runs
    main_launches, states14 = recorded["main"]
    f14, e14 = vf2_compare(si, f"RMAT {VF2_SCALE}",
                           states14.both("bitmap"))
    f17, e17 = vf2_compare(si, f"RMAT {VF2_SEARCH_SCALE}",
                           recorded["search"].both("search"))
    vids = torch.arange(kg.packed.shape[0], dtype=torch.int32, device="cuda")
    k28 = [(f"K28 RMAT {VF2_SCALE} all {vids.numel()} rows, k={kg.k}",
            lambda: kg.rows(vids),
            lambda: cp.kbit_decode_rows_plain(kg.packed, kg.deg, vids,
                                              k=kg.k, d_pad=kg.d_pad),
            kbit_bytes(kg.deg, vids, kg.k, kg.d_pad))]
    # RMAT 14's ids fill only the 8- and 16-bit buckets: the 24- and 32-bit
    # widths (k = 32's full mask) on its first rows, packed at those k
    head = cp._induce_rows(g14, np.arange(VF2_WIDE_ROWS, dtype=np.int32))
    parts = [*forms["KbitGraphBucketed"].parts.items(),
             *((kb, (cp.KbitGraph.from_csr(head, k=kb, device="cuda"),
                     np.arange(VF2_WIDE_ROWS))) for kb in (24, 32))]
    for kb, (part, pv) in parts:
        v = torch.arange(len(pv), dtype=torch.int32, device="cuda")
        k28.append((f"K28 k={kb}, {len(pv)} rows, d_pad {part.d_pad}",
                    lambda part=part, v=v: part.rows(v),
                    lambda part=part, v=v: cp.kbit_decode_rows_plain(
                        part.packed, part.deg, v, k=part.k,
                        d_pad=part.d_pad),
                    kbit_bytes(part.deg, v, part.k, part.d_pad)))
    for name, launches, calls in (
            ("vf2_feasible", main_launches["vf2_feasible"], f14 + f17),
            ("vf2_emit", main_launches["vf2_emit"], e14 + e17),
            ("kbit_decode_rows", kbit_launches, k28)):
        err, k_ms, p_ms, bound_ms, by = compare(timing, calls)
        print(f"[46] {name}: {len(calls)} launches held, max_abs_err {err}, "
              f"kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
              f"{p_ms:.4f} ms; launches of its run {launches}")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        report.append(kernel_entry(name, launches, err, k_ms, p_ms, bound_ms,
                                   by))
    return forms


# ---------------------------------------------------------------------------
# phases 47-50: the GAPBS kernels (BFS, PageRank, CC, SSSP, BC)
# ---------------------------------------------------------------------------

def rmat_weights(g):
    """w = 1 + ((u ^ v) % 9) per CSR slot (u the row, v the entry):
    symmetric, 1..9."""
    u = np.repeat(np.arange(g.num_nodes), g.degrees.astype(np.int64))
    return (1 + ((u ^ g.indices) % 9)).astype(np.int32)


def scipy_refs(g, w):
    """scipy's BFS hops (unweighted shortest_path), component labels mapped
    to each component's min id, and Dijkstra distances from vertex 0."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import (connected_components, dijkstra,
                                      shortest_path)

    n = g.num_nodes
    a = sp.csr_matrix((np.ones(g.num_edges), g.indices, g.indptr),
                      shape=(n, n))
    hops = shortest_path(a, unweighted=True, indices=0)
    hops = np.where(np.isinf(hops), -1, hops).astype(np.int64)
    nc, lab = connected_components(a, directed=False)
    mins = np.full(nc, n, dtype=np.int64)
    np.minimum.at(mins, lab, np.arange(n))
    wa = sp.csr_matrix((w.astype(np.float64), g.indices, g.indptr),
                       shape=(n, n))
    dj = dijkstra(wa, indices=0)
    dj = np.where(np.isinf(dj), -1, dj).astype(np.int64)
    return hops, mins[lab], nc, dj


def pagerank_f64(g, iters: int, damp: float = 0.85) -> np.ndarray:
    """A vectorised numpy float64 PageRank (pagerank_oracle's semantics)."""
    n = g.num_nodes
    rows = np.repeat(np.arange(n), g.degrees.astype(np.int64))
    outdeg = np.maximum(g.degrees, 1).astype(np.float64)
    pr = np.full(n, 1.0 / n)
    for _ in range(iters):
        contrib = pr / outdeg
        pr = (1 - damp) / n + damp * np.bincount(
            rows, weights=contrib[g.indices], minlength=n)
    return pr


def warm(fn, reps: int = 3):
    """(result, best host seconds of `reps` warm calls to the read-back)."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, best


def rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())


def state_calls(timing, calls, canon=None):
    """Kernels whose step updates state in place: calls are (label,
    kernel(state), plain(state), make_state(), bytes[, library(state)]).
    Each timed rep starts from a fresh make_state() (untimed) and times the
    bare call; canon(outputs) puts both outputs in one form (sorts ids
    given in any order) for the comparison only. Integer outputs are
    compared exactly, float ones also by relative error. Returns
    (max_abs_err, max_rel_err, kernel_ms, plain_ms, bound_ms, library_ms or
    None), each summed (the errors maximised) over the calls."""
    canon = canon or (lambda out: out)
    err, rel, k_ms, p_ms, bound, lib = 0, 0.0, 0.0, 0.0, 0.0, None
    for label, kernel, plain, make, nbytes, *library in calls:
        got, want = canon(kernel(make())), canon(plain(make()))
        flat = [(a, b) for a, b in zip(got, want)]
        for a, b in flat:
            if a.is_floating_point():
                err = max(err, float((a - b).abs().max()) if a.numel() else 0)
                rel = max(rel, rel_err(a, b) if a.numel() else 0.0)
            else:
                err = max(err, max_abs_err(a, b) if a.numel() else 0)
        box = {}

        def setup(make=make):
            box["s"] = make()

        kt = timing.ms(lambda: kernel(box["s"]), KERNEL_REPS, setup)
        pt = timing.ms(lambda: plain(box["s"]), PLAIN_REPS, setup)
        bt = nbytes / HBM_BYTES_PER_S * 1e3
        note = ""
        if library:
            library[0](make())
            lt = timing.ms(lambda: library[0](box["s"]), KERNEL_REPS, setup)
            lib, note = (lib or 0.0) + lt, f", library {lt:.4f} ms"
        print(f"    {label}: max_abs_err {err}, max rel err {rel:.3e}, kernel "
              f"{kt:.4f} ms, bound {bt:.4f} ms ({nbytes} bytes), plain "
              f"{pt:.4f} ms{note}")
        k_ms, p_ms, bound = k_ms + kt, p_ms + pt, bound + bt
    return err, rel, k_ms, p_ms, bound, lib


def indptr_bytes(rows) -> int:
    """The indptr words that the rows of a bool mask over n need (v and
    v + 1 of each row v), each distinct word once: 8 (n + 1) when every
    row is."""
    need = torch.zeros(rows.numel() + 1, dtype=torch.bool,
                       device=rows.device)
    need[:-1] |= rows
    need[1:] |= rows
    return 8 * int(need.sum())


def row_prefix_words(indptr, indices, live, hit):
    """Entries a pull step must read: for each live row, up to and including
    its first entry with hit, else the whole row (a mask over the CSR
    slots)."""
    n = indptr.numel() - 1
    deg = indptr.diff()
    src = torch.repeat_interleave(torch.arange(n, device=indptr.device), deg)
    pos = torch.arange(indices.numel(), device=indptr.device) - indptr[src]
    first = deg.clone()
    first.scatter_reduce_(0, src[hit], pos[hit], reduce="amin")
    need = torch.where(first < deg, first + 1, deg)
    return live[src] & (pos < need[src])


def pull_bytes(indptr, indices, dist, it: int, reached: int) -> int:
    """K29's bound: dist read once (4n: every row's own word, every
    neighbour's), the unreached rows' distinct indptr words, their entries
    up to the one that decides them, the reached rows' writes and the
    count."""
    n = dist.numel()
    live = dist == INT32_MAX
    hit = dist[indices.long()] == it
    mask = row_prefix_words(indptr, indices, live, hit)
    return (4 * n + indptr_bytes(live) + 4 * int(mask.sum()) + 4 * reached
            + 8)


def push_bytes(indptr, indices, ids, won: int) -> int:
    """K30 push: the frontier ids, their distinct indptr words and rows,
    the dist word of each distinct neighbour, the won vertices' dist and id
    writes."""
    f = ids.long()
    rows = torch.zeros(indptr.numel() - 1, dtype=torch.bool,
                       device=ids.device)
    rows[f] = True
    starts, ends = indptr[f], indptr[f + 1]
    lens = ends - starts
    pos = (torch.repeat_interleave(starts - (torch.cumsum(lens, 0) - lens),
                                   lens)
           + torch.arange(int(lens.sum()), device=ids.device))
    distinct = torch.unique(indices[pos]).numel()
    return 4 * f.numel() + indptr_bytes(rows) + 4 * int(lens.sum()) \
        + 4 * distinct + 8 * won + 8


def kbit_pull_bytes(kg, dist, it: int, reached: int) -> int:
    """K31's bound: dist read once, deg of the unreached rows, each unreached
    row's packed words up to the lane that decides it, the writes."""
    from gms_tpu_torch.graphs.compressed import kbit_decode_rows_plain

    n = dist.numel()
    live = dist == INT32_MAX
    vids = torch.arange(n, dtype=torch.int32, device=dist.device)
    words = 0
    step = max(1, (1 << 24) // max(kg.d_pad, 1))
    for v0 in range(0, n, step):
        v = vids[v0:v0 + step]
        rows = kbit_decode_rows_plain(kg.packed, kg.deg, v, k=kg.k,
                                      d_pad=kg.d_pad)
        deg = kg.deg[v.long()].long()
        hit = (rows != INT32_MAX) & (dist[rows.long().clamp(0, n - 1)] == it)
        first = torch.where(hit.any(1), hit.int().argmax(1).long() + 1, deg)
        lanes = torch.where(live[v.long()], first, 0)
        words += int(((lanes * kg.k + 31) // 32).sum())
    return 4 * n + 4 * int(live.sum()) + 4 * words + 4 * reached + 8


def bc_pass_bytes(indptr, indices, dist_final, sigma_final, max_depth,
                  forward: bool) -> tuple:
    """K34's bound over a whole pass of max_depth steps on a batch, from the
    pass's final state (a step's inputs are that state cut at its depth):
    (bytes, the record's bytes). Per step: one bit a (source, vertex) pair
    of the frontier, B n / 8 bytes (the record charged each pair's 4-byte
    dist word, 4 B n, which no layout of one bit a pair can read under);
    each row that some pair scans (forward: unreached; backward: at depth
    it), read once for the whole batch, with its distinct indptr words;
    forward, the sigma word of each distinct (source, neighbour at depth
    it) that an unreached pair reads, and the new pairs' state and sigma
    writes; backward, each pair at depth it's own sigma and its delta
    write, the sigma and delta words of each distinct (source, successor),
    and for it > 0 total's word of each scanned row, read and written."""
    B, n = dist_final.shape
    deg = indptr.diff()
    src = torch.repeat_interleave(torch.arange(n, device=indptr.device), deg)
    idx = indices.long()
    total = 0
    for it in range(max_depth):
        scan = dist_final > it if forward else dist_final == it
        rows = scan.any(0)
        total += 4 * int(deg[rows].sum()) + indptr_bytes(rows)
        for b in range(B):
            d = dist_final[b]
            if forward:
                nb, words = (d[idx] == it) & scan[b][src], 4
            else:
                nb = ((d[idx] == it + 1) & (sigma_final[b][idx] > 0)
                      & scan[b][src])
                words = 8
            seen = torch.zeros(n, dtype=torch.bool, device=d.device)
            seen[idx[nb]] = True
            total += words * int(seen.sum())
        if forward:
            total += 8 * int((dist_final == it + 1).sum())
        else:
            total += 8 * int(scan.sum()) + (8 * int(rows.sum()) if it > 0
                                            else 0)
    return (total + max_depth * (B * n // 8),
            total + max_depth * 4 * B * n)


def gapbs_phases(timing, report, g, g14, forms) -> None:
    """Phases 47-50: the GAPBS kernels (see the module docstring). g is
    phase 2's RMAT 18, g14 RMAT 14, forms phase 45's compressed forms."""
    from gms_tpu_torch.algorithms import gapbs as gb
    from gms_tpu_torch.bench.profiling import profile_window, window_lines
    from gms_tpu_torch.graphs import compressed as cp

    n, card = g.num_nodes, card_line()
    w = rmat_weights(g)
    t0 = time.perf_counter()
    hops, cc_ref, nc, dj = scipy_refs(g, w)
    print(f"[47] scipy references at RMAT {SCALE}: {time.perf_counter() - t0:.2f}"
          f" s; {(hops >= 0).sum()} reached, levels "
          f"{np.bincount(hops[hops >= 0]).tolist()}, {nc} components")
    # the host-side CSR copy each call makes (_prep), timed apart
    _, copy_s = warm(lambda: (gb._prep(g, "cuda"), torch.cuda.synchronize()))

    # [47] main path, counters from 0 just before it: one call of each
    gb.reset_launches()
    runs = {
        "bfs": lambda: gb.bfs(g, 0, device="cuda"),
        "bfs pull-only": lambda: gb.bfs(g, 0, direction_optimizing=False,
                                        device="cuda"),
        "connected_components": lambda: gb.connected_components(
            g, device="cuda"),
        "sssp unit": lambda: gb.sssp(g, 0, device="cuda"),
        "sssp weighted": lambda: gb.sssp(g, 0, w, device="cuda"),
        "pagerank": lambda: gb.pagerank(g, iters=20, device="cuda"),
    }
    out, steps, first = {}, {}, {}
    for label, fn in runs.items():
        t0 = time.perf_counter()
        out[label] = fn()
        first[label] = time.perf_counter() - t0
        steps[label] = (list(gb.STEPS["bfs"]) if label.startswith("bfs")
                        else gb.STEPS["cc"] if label.startswith("conn")
                        else gb.STEPS["sssp"] if label.startswith("sssp")
                        else 20)
    main_launches = dict(gb.LAUNCHES)
    dirs = steps["bfs"]
    d = out["bfs"]
    print(f"[47] bfs(g, 0) d-opt: levels {dirs} (f_cap "
          f"{max(64, (n + 8) // 8 * 8 // 16)}); {(d >= 0).sum()} reached")
    check(dirs == GAPBS_DIRECTIONS, f"BFS directions {dirs}")
    check(np.array_equal(d, hops) and np.array_equal(out["bfs pull-only"],
                                                     hops),
          "BFS differs from scipy's shortest_path")
    check(int((d >= 0).sum()) == GAPBS_REACHED, "BFS reached count")
    check(np.array_equal(out["connected_components"], cc_ref)
          and nc == GAPBS_COMPONENTS, "CC differs from scipy's")
    check(np.array_equal(out["sssp unit"], hops), "unit SSSP != BFS")
    s = out["sssp weighted"]
    check(np.array_equal(s, dj) and (int(s.max()), int(s[s >= 0].sum()))
          == GAPBS_SSSP, "weighted SSSP differs from scipy's dijkstra")
    pr = out["pagerank"]
    want_pr = pagerank_f64(g, 20)
    ok_pr = np.allclose(pr, want_pr, rtol=1e-4, atol=1e-7)
    print(f"[47] connected_components: {nc} components, "
          f"{steps['connected_components']} rounds; sssp unit "
          f"{steps['sssp unit']} rounds, weighted {steps['sssp weighted']} "
          f"rounds, max {int(s.max())}, sum {int(s[s >= 0].sum())}; pagerank "
          f"sum {float(pr.sum())}, max rel err to the float64 oracle "
          f"{float(np.max(np.abs(pr - want_pr) / want_pr)):.3e}")
    check(ok_pr, "PageRank differs from the float64 oracle")
    for label, fn in runs.items():
        _, best = warm(fn)
        print(f"[47] {label}: first call {first[label]:.4f} s, best "
              f"of 3 warm {best:.4f} s (host clock to the read-back; the "
              f"host CSR copy alone {copy_s:.4f} s) | {card}")
        if label == "bfs":
            print(f"    reference informal scale-18 Kronecker BFS "
                  f"(BASELINE.md:13, another machine, another graph "
                  f"generator): ~0.0053 s parallel plain bfs")
    print(f"[47] main path launches {main_launches}")
    for name in ("bfs_pull", "frontier_ids", "bfs_push", "pr_pull",
                 "cc_step", "sssp_step"):
        check(main_launches[name] > 0, f"{name} never launched")

    # [48] BC at RMAT 18, counters from 0 just before
    gb.reset_launches()
    depth = gb.bc_max_depth(g, device="cuda")
    t0 = time.perf_counter()
    bc = gb.betweenness_centrality(g, num_samples=BC_SAMPLES, seed=0,
                                   device="cuda")
    first_s = time.perf_counter() - t0
    bc_launches = dict(gb.LAUNCHES)
    _, best = warm(lambda: gb.betweenness_centrality(
        g, num_samples=BC_SAMPLES, seed=0, device="cuda"))
    indptr, indices, _, _, _ = gb._prep(g, "cuda")
    # the main path's own batch: all its sources, state [len(src), n]
    src = gb.bc_sources(n, None, BC_SAMPLES, 0)
    check(len(src) <= gb.BC_BATCH, f"{len(src)} BC sources, not one batch")
    kt = gb._bc_total(indptr, indices, n, src, depth)
    pt = gb._bc_total(indptr, indices, n, src, depth, gb.bc_forward_plain,
                      gb.bc_backward_plain)
    bc_rel = rel_err(kt[pt > 0], pt[pt > 0])
    print(f"[48] betweenness_centrality(g, num_samples={BC_SAMPLES}, seed=0):"
          f" max_depth {depth}; argmax {int(bc.argmax())}; first call "
          f"{first_s:.4f} s, best of 3 warm {best:.4f} s | {card}; launches "
          f"{bc_launches}; kernels vs plain on its batch of {len(src)} "
          f"sources: max rel err {bc_rel:.3e}")
    check(depth == GAPBS_BC_DEPTH, f"BC max_depth {depth}")
    check(bc_launches["bc_forward"] == bc_launches["bc_backward"]
          == depth * -(-BC_SAMPLES // gb.BC_BATCH), "BC launches")
    check(bool(torch.allclose(kt, pt, rtol=1e-4, atol=1e-5)),
          "BC kernels differ from the plain version")
    # K34 over one warm call, and BC's bits on a second run
    again, host_s, per, busy = profile_window(
        lambda: gb.betweenness_centrality(g, num_samples=BC_SAMPLES, seed=0,
                                          device="cuda"))
    same = bool(np.array_equal(again, bc)) and bool(torch.equal(
        kt, gb._bc_total(indptr, indices, n, src, depth)))
    window_lines("[48] warm BC call under torch.profiler:", host_s, per, busy,
                 {"K34 forward": K34_FORWARD, "K34 backward": K34_BACKWARD})
    print(f"[48] BC gives the same bits on a second run (the call's scores "
          f"and the kernels' total): {same}")
    check(same, "BC gives other bits on a second run")

    # [49] the compressed forms and the goldens at RMAT 14
    w14 = rmat_weights(g14)

    def dig(a, dtype):
        return hashlib.sha256(np.ascontiguousarray(
            a, dtype=dtype).tobytes()).hexdigest()[:16]

    got = {f"bfs {name}": dig(gb.bfs(rep, 0, device="cuda"), np.int32)
           for name, rep in forms.items()}
    got["bfs CSR"] = dig(gb.bfs(g14, 0, device="cuda"), np.int32)
    gb.reset_launches()
    got["bfs_kbit"] = dig(gb.bfs_kbit(forms["KbitGraph"], 0, device="cuda"),
                          np.int32)
    kbit_launches = gb.LAUNCHES["bfs_kbit_pull"]
    got["cc"] = dig(gb.connected_components(g14, device="cuda"), np.int32)
    got["sssp"] = dig(gb.sssp(g14, 0, device="cuda"), np.int64)
    got["sssp weighted"] = dig(gb.sssp(g14, 0, w14, device="cuda"), np.int64)
    kw = cp.KbitWeightedGraph.from_csr(g14, w14, device="cuda")
    got["sssp KbitWeightedGraph"] = dig(gb.sssp(kw, 0, device="cuda"),
                                        np.int64)
    for key, val in got.items():
        want = GAPBS_GOLDEN_14[key.split()[0] if key.startswith("bfs")
                               else key.replace(" KbitWeightedGraph",
                                                " weighted")]
        print(f"[49] RMAT {VF2_SCALE} {key}: {val} (gms_tpu {want})")
        check(val == want, f"{key} digest {val} != gms_tpu's {want}")
    pr14 = gb.pagerank(g14, iters=20, device="cuda")
    bc14 = gb.betweenness_centrality(g14, num_samples=BC_SAMPLES, seed=0,
                                     device="cuda")
    ps, pa, pm = PR_GOLDEN_14
    bs = BC_GOLDEN_14[1]
    print(f"[49] pagerank: sum {float(pr14.sum())} (gms_tpu {ps}), argmax "
          f"{int(pr14.argmax())}, max {float(pr14.max())} ({pm}); bc argmax "
          f"{int(bc14.argmax())}, sum {float(bc14.sum())} ({bs})")
    check(int(pr14.argmax()) == pa and abs(pr14.sum() - ps) <= 1e-5 * ps
          and abs(pr14.max() - pm) <= 1e-5 * pm, "PageRank RMAT 14")
    check(int(bc14.argmax()) == BC_GOLDEN_14[0]
          and abs(bc14.sum() - bs) <= 1e-4 * bs, "BC RMAT 14")
    check(kbit_launches > 0, "bfs_kbit_pull never launched")

    # [50] each kernel against its plain version on the work above
    inf = INT32_MAX
    dist18 = torch.from_numpy(np.where(hops < 0, inf, hops).astype(
        np.int32)).cuda()

    def at_level(final, it):
        return torch.where(final <= it, final, inf).to(torch.int32)

    src_rows = torch.repeat_interleave(torch.arange(n, device="cuda"),
                                       indptr.diff())
    idx = indices.long()
    adj = torch.sparse_csr_tensor(indptr, idx, torch.ones(
        indices.numel(), device="cuda"), (n, n), check_invariants=True)
    levels = int(hops.max()) + 1
    counts = np.bincount(hops[hops >= 0])
    calls = {"bfs_pull": [], "frontier_ids": [], "bfs_push": [],
             "bfs_kbit_pull": [], "pr_pull": [], "cc_step": [],
             "sssp_step": []}
    for it in range(levels):
        reached = int(counts[it + 1]) if it + 1 < len(counts) else 0
        calls["bfs_pull"].append((
            f"bfs_pull RMAT {SCALE} level {it}",
            lambda s, it=it: (gb.bfs_pull(indptr, indices, s, it), s),
            lambda s, it=it: (gb.bfs_pull_plain(indptr, indices, s, it), s),
            lambda it=it: at_level(dist18, it),
            pull_bytes(indptr, indices, at_level(dist18, it), it, reached),
            # "any neighbour in the frontier" as one scatter_reduce_ (amax)
            # of the frontier over the edge list
            lambda s, it=it: torch.zeros(
                n, dtype=torch.int32, device="cuda").scatter_reduce_(
                    0, src_rows, (s[idx] == it).int(), reduce="amax")))
    for it, dname in enumerate(dirs):
        if dname != "push":
            continue
        st = at_level(dist18, it)
        ids, fc = gb.frontier_ids_plain(st, it)
        fc = int(fc)
        reached = int(counts[it + 1]) if it + 1 < len(counts) else 0

        if it > 0 and dirs[it - 1] == "pull":     # compacted, not pushed
            calls["frontier_ids"].append((
                f"frontier_ids RMAT {SCALE} level {it} ({fc} ids)",
                lambda s, it=it: gb.frontier_ids(s, it),
                lambda s, it=it: gb.frontier_ids_plain(s, it),
                lambda st=st: st, 4 * n + 4 * fc + 8))
        calls["bfs_push"].append((
            f"bfs_push RMAT {SCALE} level {it} ({fc} frontier)",
            lambda s, it=it, ids=ids, fc=fc: gb.bfs_push(
                indptr, indices, ids, fc, s, it) + (s,),
            lambda s, it=it, ids=ids, fc=fc: gb.bfs_push_plain(
                indptr, indices, ids, fc, s, it) + (s,),
            lambda st=st: st.clone(),
            push_bytes(indptr, indices, ids[:fc], reached)))
    kg = forms["KbitGraph"]
    h14 = gb.bfs(g14, 0, device="cuda")
    d14 = torch.from_numpy(np.where(h14 < 0, inf, h14).astype(
        np.int32)).cuda()
    c14 = np.bincount(h14[h14 >= 0])
    for it in range(int(h14.max()) + 1):
        reached = int(c14[it + 1]) if it + 1 < len(c14) else 0
        calls["bfs_kbit_pull"].append((
            f"bfs_kbit_pull RMAT {VF2_SCALE} k={kg.k} level {it}",
            lambda s, it=it: (gb.bfs_kbit_pull(kg.packed, kg.deg, s, it,
                                               k=kg.k, d_pad=kg.d_pad), s),
            lambda s, it=it: (gb.bfs_kbit_pull_plain(
                kg.packed, kg.deg, s, it, k=kg.k, d_pad=kg.d_pad), s),
            lambda it=it: at_level(d14, it),
            kbit_pull_bytes(kg, at_level(d14, it), it, reached)))
    deg18 = torch.from_numpy(g.degrees.astype(np.int32)).cuda()
    e = indices.numel()
    nbrs = torch.unique(indices).numel()
    pr0 = torch.full((n,), float(np.float32(1.0) / np.float32(n)),
                     device="cuda")
    base = float(np.float32(1.0 - 0.85) / np.float32(n))
    damp = float(np.float32(0.85))
    prn = torch.from_numpy(pr).cuda()
    # the row schedule that pagerank builds once a call, built as it does
    sched18, build18 = schedule_build(indptr)
    for lab, p in (("iteration 1", pr0), ("iteration 21", prn)):
        calls["pr_pull"].append((
            f"pr_pull RMAT {SCALE} {lab}",
            lambda s: (gb.pr_pull(indptr, indices, deg18, s, base, damp,
                                  schedule=sched18),),
            lambda s: (gb.pr_pull_plain(indptr, indices, deg18, s, base,
                                        damp),),
            lambda p=p: p, 8 * (n + 1) + 4 * e + 8 * nbrs + 4 * n,
            # torch.sparse.mm of the CSR matrix with contrib, the division
            # and the axpy beside it
            lambda s: base + damp * torch.sparse.mm(
                adj, (s / deg18.clamp(min=1).float())[:, None])[:, 0]))
    lab18 = torch.arange(n, dtype=torch.int32, device="cuda")
    ccf = torch.from_numpy(out["connected_components"]).cuda()
    for lab, st in (("step 1", lab18), ("last step", ccf)):
        calls["cc_step"].append((
            f"cc_step RMAT {SCALE} {lab}",
            lambda s: gb.cc_step(indptr, indices, s),
            lambda s: gb.cc_step_plain(indptr, indices, s),
            lambda st=st: st, 8 * (n + 1) + 4 * e + 4 * n + 4 * n + 4,
            lambda s: s.clone().scatter_reduce_(0, src_rows, s[idx],
                                                reduce="amin")))
    w18 = torch.from_numpy(w).cuda()
    big = gb.BIG
    s0 = torch.full((n,), big, dtype=torch.int64, device="cuda")
    s0[0] = 0
    sf = torch.from_numpy(np.where(s < 0, big, s)).cuda()
    for lab, st in (("step 1", s0), ("last step", sf)):
        calls["sssp_step"].append((
            f"sssp_step RMAT {SCALE} weighted {lab}",
            lambda s: gb.sssp_step(indptr, indices, w18, s),
            lambda s: gb.sssp_step_plain(indptr, indices, w18, s),
            lambda st=st: st, 8 * (n + 1) + 8 * e + 8 * n + 8 * n + 4,
            lambda s: s.clone().scatter_reduce_(0, src_rows, s[idx] + w18,
                                                reduce="amin")))
    launches = dict(main_launches, bfs_kbit_pull=kbit_launches, **{
        k: bc_launches[k] for k in ("bc_forward", "bc_backward")})
    def sorted_ids(out):
        """(ids, count, *rest) with the first count ids sorted."""
        ids, c = out[:2]
        return (ids[:int(c)].sort().values, c) + tuple(out[2:])

    for name, kcalls in calls.items():
        rtol = 1e-5 if name == "pr_pull" else None
        err, rel, k_ms, p_ms, bound_ms, lib_ms = state_calls(
            timing, kcalls, sorted_ids if name in ("frontier_ids", "bfs_push")
            else None)
        print(f"[50] {name}: {len(kcalls)} launches held, max_abs_err {err}, "
              f"max rel err {rel:.3e}, kernel {k_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms (bytes), plain {p_ms:.4f} ms, library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms; launches "
              f"of its run {launches[name]} | {card}")
        if rtol is None:
            check(err == 0, f"{name} disagrees with its plain version by "
                            f"{err}")
        else:
            check(rel <= rtol, f"{name} off its plain version by {rel}")
        report.append(kernel_entry(name, launches[name], err, k_ms, p_ms,
                                   bound_ms, "bytes", library_ms=lib_ms))

    # K32 gives the same bits on every run; the floor of the timing, and
    # batched figures (BATCH_STEPS back-to-back iterations from iteration
    # 21's state) of K32 and of torch.sparse.mm's pull
    def k32():
        return gb.pr_pull(indptr, indices, deg18, prn, base, damp,
                          schedule=sched18)

    def spmm():
        return base + damp * torch.sparse.mm(
            adj, (prn / deg18.clamp(min=1).float())[:, None])[:, 0]

    same = all(torch.equal(k32(), k32()) for _ in range(2))
    k_us, k_per = device_us(k32)
    l_us, l_per = device_us(spmm)
    print(f"[50] pr_pull on RMAT {SCALE}: the same bits on two runs, twice: "
          f"{same}; row schedule ({sched18.n_narrow} narrow rows, "
          f"{sched18.n_seg} segments, {sched18.n_wide} wide rows) built in "
          f"{build18:.4f} ms (host clock, synchronised); batched "
          f"({BATCH_STEPS} back-to-back) K32 {batched_ms(timing, k32):.4f} "
          f"ms an iteration, torch.sparse.mm {batched_ms(timing, spmm):.4f} "
          f"ms; device µs an iteration (torch.profiler, {BATCH_STEPS} "
          f"iterations) K32 {k_us} {k_per}, torch.sparse.mm {l_us} {l_per}; "
          f"the Timing floor (a 4-byte fill) {floor_ms(timing):.4f} ms "
          f"| {card}")
    check(same, "pr_pull gives other bits on another run")
    # K34: the forward and the backward pass of phase 48's batch, on the
    # row schedule the call builds
    fwd_k = functools.partial(gb.bc_forward, schedule=sched18)
    bwd_k = functools.partial(gb.bc_backward, schedule=sched18)
    B = len(src)

    def fwd_state():
        return gb.bc_state(n, src, depth, "cuda")[:3]

    def forward(step):
        def run(st):
            for it in range(depth):
                step(indptr, indices, *st, it)
            return st
        return run

    fin = forward(fwd_k)(fwd_state())   # (lvl, seen, sigma)

    def bwd_state():
        return (fin[0], fin[2], torch.zeros_like(fin[2]),
                torch.zeros(n, dtype=torch.float32, device="cuda"))

    def backward(step):
        def run(st):
            for it in range(depth - 1, -1, -1):
                step(indptr, indices, *st[:3], it, st[3])
            return st[2], st[3]
        return run

    dist_fin = gb.bc_dist(fin[0], B)
    sigma_fin = fin[2][:, :B].T.contiguous()
    for name, kernel, plain, make, fwd in (
            ("bc_forward", forward(fwd_k), forward(gb.bc_forward_plain),
             fwd_state, True),
            ("bc_backward", backward(bwd_k), backward(gb.bc_backward_plain),
             bwd_state, False)):
        nbytes, record = bc_pass_bytes(indptr, indices, dist_fin, sigma_fin,
                                       depth, fwd)
        err, rel, k_ms, p_ms, bound_ms, _ = state_calls(timing, [(
            f"{name} RMAT {SCALE}, {B} sources, {depth} steps",
            kernel, plain, make, nbytes)])
        print(f"[50] {name}: {depth} launches held, max_abs_err {err}, max "
              f"rel err {rel:.3e}, kernel {k_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms (bytes; one bit a pair a step; the "
              f"record's 4-byte dist word a pair: {record} bytes -> "
              f"{record / HBM_BYTES_PER_S * 1e3:.4f} ms), plain "
              f"{p_ms:.4f} ms; launches of its run {launches[name]} | {card}")
        check(rel <= 1e-4, f"{name} off its plain version by {rel}")
        report.append(kernel_entry(name, launches[name], err, k_ms, p_ms,
                                   bound_ms, "bytes"))
    # a yardstick, not a library figure (it does not compute the step):
    # torch.sparse.mm of the CSR by each step's masked sigma [n, 64], the
    # forward step's sum alone, over the pass
    bits = torch.arange(gb.BC_BATCH, dtype=torch.int64, device="cuda")
    masked = [torch.where(((fin[0][it][:, None] >> bits) & 1).bool(),
                          fin[2], 0.0) for it in range(depth)]

    def spmm_pass():
        for m in masked:
            torch.sparse.mm(adj, m)

    spmm_pass()
    print(f"[50] note: torch.sparse.mm of the CSR by the masked sigma "
          f"[{n}, {gb.BC_BATCH}], the {depth} forward steps' sums alone, "
          f"{timing.ms(spmm_pass, KERNEL_REPS):.4f} ms (L2 flushed) | {card}")
    del masked


def direct_plan(g, rank):
    """The direct path's inputs for the roots of degree <= 1024: (padded
    undirected rows, rank_pad, core bound, [(chunk, ww)]) on the card, as
    bron_kerbosch(direct=True) builds them."""
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.graphs.tiles import PaddedGraph
    n = g.num_nodes
    pg = PaddedGraph.from_csr(g, device="cuda", lane=32)
    rank_pad = np.full(pg.v_pad + 1, INT32_MAX, np.int32)
    rank_pad[:n] = rank
    e = g.edge_array()
    higher = rank[e[:, 1]] > rank[e[:, 0]]
    core = int(np.bincount(e[:, 0][higher], minlength=n).max(initial=1))
    roots = np.nonzero(g.degrees <= 1024)[0].astype(np.int32)
    chunks = [(torch.from_numpy(c).cuda(), ww) for c, ww in
              kc.plan_tier_chunks(g.degrees, roots, np.int32(pg.v_pad),
                                  root_chunk=bk.DEFAULT_ROOT_CHUNK)]
    return pg, torch.from_numpy(rank_pad).cuda(), core, chunks


def init_items_bytes(pg, chunk, ww) -> int:
    """K35's bytes: the roots, their rows' first min(W, deg + 1) slots, the
    ranks of the roots and of their neighbours, cand and fini written."""
    roots = chunk.long().clamp(0, pg.v_pad - 1)
    deg = pg.deg[roots].long().clamp(max=32 * ww)
    c = chunk.numel()
    return (c + data_words(pg.deg, roots, 32 * ww) + c + int(deg.sum())
            + 2 * c * ww) * 4


def direct_bytes(pg, chunk, live, ww) -> int:
    """K36's bytes: the adj rows of each live root's slots j < deg (its
    search reads no other: cand | fini lie in those slots, padded slots and
    dead roots' rows stay unread), the live roots' cand0 and fini0, live0,
    and the count and overflow written."""
    deg = pg.deg[chunk[live].long()].long().clamp(max=32 * ww)
    return ((int(deg.sum()) + 2 * int(live.sum())) * ww * 4 + live.numel()
            + 8)


def direct_cut(univ, depth, total):
    """A wide job's roots that the plain search can take: K36's count with
    each live root alone (the counts must sum to the job's `total`), then
    the roots in job order, each kept while the cut's cliques times W * WW
    (the words the plain search gathers a node) stay within
    BK_DIRECT_PLAIN_WORDS. Returns (the cut's live mask, a note)."""
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    adj, cand, fini, live = univ
    C, W, WW = adj.shape
    ids = live.nonzero()[:, 0].tolist()
    runs = []
    for b in ids:
        one = torch.zeros_like(live)
        one[b] = True
        runs.append(torch.stack([t.long() for t in bk.bk_direct_stack(
            adj, cand, fini, one, depth=depth)]))
    counts, ovf = torch.stack(runs).T.tolist()
    check(sum(counts) == total and not any(ovf),
          f"W={W}: K36 root by root {sum(counts)} (overflow {any(ovf)}) != "
          f"the job's {total}")
    cut, kept = torch.zeros_like(live), 0
    for b, c in zip(ids, counts):
        if (kept + c) * W * WW <= BK_DIRECT_PLAIN_WORDS:
            cut[b], kept = True, kept + c
    check(kept > 0, f"W={W}: no root fits the plain search's budget")
    return cut, (f", cut to {int(cut.sum())} of {len(ids)} roots ({kept} "
                 f"cliques; root by root = the job's count, the largest "
                 f"root {max(counts)})")


def direct_compare(timing, label, univ, depth, rates, nbytes):
    """K36 against one plain run on a job's (adj, cand0, fini0, live0): its
    count and overflow; bound as K9's (search_compare), with nbytes from
    direct_bytes. Returns search_compare's tuple, with no emit time."""
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    stats = {}
    want = bk.bk_direct_stack_plain(*univ, depth=depth, stats=stats)
    diff = max_abs_err(bk.bk_direct_stack(*univ, depth=depth), want)
    kt = timing.ms(lambda: bk.bk_direct_stack(*univ, depth=depth),
                   KERNEL_REPS)
    pt = timing.ms(lambda: bk.bk_direct_stack_plain(*univ, depth=depth), 1)
    bt = nbytes / HBM_BYTES_PER_S * 1e3
    popc, bit, ot = own_ops(stats, rates)
    tree = max(stats["popc_ops"] / rates[0],
               stats["bit_ops"] / rates[1]) * 1e3
    print(f"    {label}: count {int(want[0])}, max_abs_err {diff}, kernel "
          f"{kt:.4f} ms, bound {max(bt, ot):.4f} ms ({nbytes} bytes -> "
          f"{bt:.4f} ms; {popc} popcounts, {bit} bitwise ops -> {ot:.4f} "
          f"ms; the plain tree's {stats['popc_ops']} and {stats['bit_ops']} "
          f"-> {tree:.4f} ms), plain {pt:.4f} ms")
    return diff, kt, 0.0, pt, bt, ot, popc, bit, tree


def direct_phases(timing, report, g):
    """Phases 51-52: the direct=True Bron-Kerbosch variant (see the module
    docstring); g is RMAT 14. Returns RMAT 12 and its rank."""
    from gms_tpu_torch.bench.profiling import (BK_GROUPS, profile_window,
                                               window_lines)
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.preprocessing import degeneracy

    def launches():
        return dict(bk.LAUNCHES,
                    build_local_adj=kc.LAUNCHES["build_local_adj"])

    rank, _ = degeneracy.degeneracy_ordering_rank(g)
    t0 = time.perf_counter()
    first = bk.bron_kerbosch(g, device="cuda", rank=rank, direct=True)
    first_s = time.perf_counter() - t0
    # [51] main path, counters from 0
    bk.reset_launches()
    kc.reset_launches()
    t0 = time.perf_counter()
    count = bk.bron_kerbosch(g, device="cuda", rank=rank, direct=True)
    warm_s = time.perf_counter() - t0
    main = launches()
    t0 = time.perf_counter()
    fused = bk.bron_kerbosch(g, device="cuda", rank=rank)
    fused_s = time.perf_counter() - t0
    hubs = np.nonzero(g.degrees > 1024)[0].astype(np.int32)
    hub_n, _ = bk._bk_fused(g, rank, hubs, ["cuda"])
    print(f"[51] RMAT {BK_SCALE} direct=True: count {count} (first call "
          f"{first}, {first_s:.4f} s), golden {BK_GOLDEN}; warm call "
          f"{warm_s:.4f} s, {count / warm_s:.1f} cliques/s; the fused "
          f"default call {fused_s:.4f} s (count {fused}); {len(hubs)} roots "
          f"of degree > 1024 on the fused path hold {hub_n} cliques, the "
          f"{g.num_nodes - len(hubs)} direct roots {count - hub_n}; "
          f"launches {main}")
    check(count == first == fused == BK_GOLDEN,
          f"RMAT {BK_SCALE} direct BK: {count}, {first}, fused {fused}")
    check(all(main[n] > 0 for n in ("init_items", "bk_direct_stack",
                                    "build_local_adj")),
          f"a kernel of the direct path never launched: {main}")
    check((main["bk_stack_machine"] > 0) == bool(len(hubs)),
          f"the hub roots' fused path: {main}")
    again, host_s, per, busy = profile_window(
        lambda: bk.bron_kerbosch(g, device="cuda", rank=rank, direct=True))
    check(again == BK_GOLDEN, f"the profiled direct call gave {again}")
    window_lines("[51] warm direct call under torch.profiler:", host_s, per,
                 busy, BK_GROUPS)
    hubs64 = np.nonzero(g.degrees > BK_DIRECT_HUB)[0].astype(np.int32)
    bk.reset_launches()
    t0 = time.perf_counter()
    count64 = bk.bron_kerbosch(g, device="cuda", rank=rank, direct=True,
                               hub_threshold=BK_DIRECT_HUB)
    s64 = time.perf_counter() - t0
    hub64_n, _ = bk._bk_fused(g, rank, hubs64, ["cuda"])
    print(f"    hub_threshold={BK_DIRECT_HUB}: count {count64}, "
          f"{s64:.4f} s; {len(hubs64)} fused roots hold {hub64_n} cliques, "
          f"the direct roots {count64 - hub64_n}; launches {dict(bk.LAUNCHES)}")
    check(count64 == BK_GOLDEN, f"hub_threshold={BK_DIRECT_HUB}: {count64}")
    small = build_csr(generate_rmat_el(BK_SMALL, DEGREE, seed=SEED),
                      num_nodes=1 << BK_SMALL)
    srank, _ = degeneracy.degeneracy_ordering_rank(small)
    t0 = time.perf_counter()
    c12 = bk.bron_kerbosch(small, device="cuda", rank=srank, direct=True)
    s12 = time.perf_counter() - t0
    f12 = bk.bron_kerbosch(small, device="cuda", rank=srank)
    print(f"    RMAT {BK_SMALL} direct=True: {c12} ({s12:.4f} s), fused "
          f"{f12}, reference {BK_DIRECT_SMALL_GOLDEN}")
    check(c12 == f12 == BK_DIRECT_SMALL_GOLDEN,
          f"RMAT {BK_SMALL} direct BK {c12}, fused {f12}")

    # [52] the main path's jobs: K36 timed whole; K35 against plain on
    # each, K36 on each whole or cut to the roots the plain search can take
    pg, rank_pad, core, chunks = direct_plan(g, rank)
    rates = (sm_rate(POPC_PER_CLOCK_PER_SM), sm_rate(BITWISE_PER_CLOCK_PER_SM))
    k35_calls, results, k36_main = [], [], 0.0
    print(f"[52] RMAT {BK_SCALE} direct jobs (core bound {core}, K36 path "
          f"min(W, {core}) + 2 levels; a block's 8 paths in device memory "
          f"above 100 KB):")
    for chunk, ww in chunks:
        W = 32 * ww
        label = f"RMAT {BK_SCALE} W={W} C={chunk.numel()}"
        k35_calls.append((
            label, lambda c=chunk, w=ww: bk.init_items(pg.nbr, rank_pad, c,
                                                       w_words=w),
            lambda c=chunk, w=ww: bk.init_items_plain(pg.nbr, rank_pad, c,
                                                      w_words=w),
            init_items_bytes(pg, chunk, ww)))
        adj, _ = kc.build_local_adj(pg.nbr, chunk, w_words=ww)
        cand, fini = bk.init_items(pg.nbr, rank_pad, chunk, w_words=ww)
        univ = (adj, cand, fini, chunk != pg.v_pad)
        depth = min(W, core) + 2
        stats = {}
        n, ovf = (int(x) for x in bk.bk_direct_stack(*univ, depth=depth,
                                                      stats=stats))
        ms = timing.ms(lambda u=univ, d=depth: bk.bk_direct_stack(
            *u, depth=d), 3)
        k36_main += ms
        path_kb = 8 * depth * (2 * ww + 1) * 4 / 1024
        print(f"    {label} real roots {int(univ[3].sum())}: {n} cliques, "
              f"overflow {bool(ovf)}, {ms:.4f} ms; paths {path_kb:.1f} KB a "
              f"block; stats=: {walk_split(stats)}")
        check(not ovf, f"K36 overflowed at W={W}")
        if n * W * ww > BK_DIRECT_PLAIN_WORDS:
            live, note = direct_cut(univ, depth, n)
            univ, label = (adj, cand, fini, live), label + note
        results.append(direct_compare(
            timing, label, univ, depth, rates,
            direct_bytes(pg, chunk, univ[3], ww)))
    err, k_ms, p_ms, bound_ms, by = compare(timing, k35_calls)
    print(f"[52] init_items: {len(k35_calls)} RMAT {BK_SCALE} jobs, "
          f"max_abs_err {err}, kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({by}), plain {p_ms:.4f} ms")
    check(err == 0, f"init_items disagrees with its plain version by {err}")
    report.append(kernel_entry("init_items", main["init_items"], err, k_ms,
                               p_ms, bound_ms, by))
    err, k_ms, _, p_ms, popc, bit, bound, by, tree = search_summary(results)
    print(f"[52] bk_direct_stack: {len(results)} RMAT {BK_SCALE} jobs (the "
          f"wide ones cut), max_abs_err {err} (count and overflow), kernel "
          f"{k_ms:.4f} ms, bound {bound:.4f} ms ({by}; {popc} popcounts, "
          f"{bit} bitwise ops; the plain tree's count {tree:.4f} ms), plain "
          f"{p_ms:.4f} ms; the whole jobs {k36_main:.4f} ms (median of 3)")
    check(err == 0, f"bk_direct_stack disagrees with its plain version by "
                    f"{err}")
    report.append(kernel_entry("bk_direct_stack", main["bk_direct_stack"],
                               err, k_ms, p_ms, bound, by))
    return small, srank


def expand_bytes_ops(S, R, adj, cap, live=None):
    """K37's bytes (the rows of S and R below the live count read, all N
    without one; each adj row the set bits need; every row of S_out and
    R_out written, the zero rows included) and AND+popcounts (WW a set bit
    of S), counted in batches of items."""
    from gms_tpu_torch.algorithms import k_clique as kc
    C, W, WW = adj.shape
    rows = S.shape[0] if live is None else min(S.shape[0], live)
    used = torch.zeros(C * W, dtype=torch.bool, device=S.device)
    bits = 0
    step = max(1, (1 << 24) // W)
    for n0 in range(0, rows, step):
        item, i = kc.unpack_bits(S[n0:min(n0 + step, rows)]).nonzero(
            as_tuple=True)
        used[R[n0 + item].long().clamp(0, C - 1) * W + i] = True
        bits += item.numel()
    return ((rows * (WW + 1) + int(used.sum()) * WW + cap * (WW + 1)) * 4
            + 16, bits * WW)


def world_rank_counts(mesh):
    """Phase 55's run on one rank of a spawned world: the sharded triangle
    count on RMAT 16 and the sharded k-clique count on RMAT 12, each twice
    (the second timed warm)."""
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.parallel import multi, sharding
    out = {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device)}
    g16 = build_csr(generate_rmat_el(MULTI_TC_SCALE, DEGREE, seed=SEED),
                    num_nodes=1 << MULTI_TC_SCALE)
    g12 = build_csr(generate_rmat_el(MULTI_KC_SCALE, DEGREE, seed=SEED),
                    num_nodes=1 << MULTI_KC_SCALE)
    for key, call in (
            ("tc", lambda: sharding.sharded_triangle_count(g16, mesh)),
            ("kc", lambda: multi.sharded_kclique_count(g12, MULTI_K, mesh))):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[key] = call()
        out[key + "_s"] = time.perf_counter() - t0
    out["staged"] = dict(mesh.staged)
    return out


def multi_phases(timing, report, g18, g14, g12, lp_pairs):
    """Phases 53-55: the multi-device layer (see the module docstring)."""
    from gms_tpu_torch.bench.profiling import profile_window, window_lines
    import torch.distributed as dist
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.algorithms import similarity as vs
    from gms_tpu_torch.algorithms import triangle_count as tc
    from gms_tpu_torch.graphs.tiles import PaddedGraph
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.parallel import multi, sharding, world
    from gms_tpu_torch.preprocessing import degeneracy, orient

    # [53] world size 1 over NCCL; its bootstrap stays on the loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = world.init_local("nccl")
    mesh = sharding.make_mesh()
    print(f"[53] torch.distributed {dist.get_backend()}: world {mesh.size}, "
          f"rank {mesh.rank}, device {mesh.device}, store "
          f"tcp://127.0.0.1:{store.port}")
    scale, k, golden = KCLIQUE_RUNS[0]
    g = build_csr(generate_rmat_el(scale, DEGREE, seed=SEED),
                  num_nodes=1 << scale)
    rank, _ = degeneracy.degeneracy_ordering_rank(g)
    kc.reset_launches()
    stats = {}
    t0 = time.perf_counter()
    got = multi.sharded_kclique_count(g, k, mesh, rank=rank, stats=stats)
    first_s = time.perf_counter() - t0
    main = {n: kc.LAUNCHES[n] for n in ("build_local_adj", "expand_level",
                                        "total_popcount")}
    t0 = time.perf_counter()
    warm = multi.sharded_kclique_count(g, k, mesh, rank=rank)
    warm_s = time.perf_counter() - t0
    kc.kclique_count(g, k, device="cuda", rank=rank)
    t0 = time.perf_counter()
    single = kc.kclique_count(g, k, device="cuda", rank=rank)
    single_s = time.perf_counter() - t0
    print(f"[53] RMAT {scale} k={k} sharded_kclique_count: {got}, golden "
          f"{golden}; first call {first_s:.4f} s, warm {warm_s:.4f} s; "
          f"{stats['chunks']} chunks of 256 roots, {stats['doublings']} cap "
          f"doublings; kclique_count on the same graph {single_s:.4f} s "
          f"(warm); launches {main}")
    check(got == warm == single == golden,
          f"sharded k-clique {got}, {warm}, kclique_count {single}")
    kc.reset_launches()
    again, host_s, per, busy = profile_window(
        lambda: multi.sharded_kclique_count(g, k, mesh, rank=rank))
    check(again == golden, f"the profiled sharded call gave {again}")
    sums = window_lines("[53] warm sharded call under torch.profiler:",
                        host_s, per, busy,
                        {"K37": K37_KERNELS, "K4": ("local_adj_kernel",),
                         "K38": ("popcount_kernel",)})
    print(f"    its launches {dict(kc.LAUNCHES)}")
    check(all(v > 0 for v in main.values()),
          f"a kernel of the sharded k-clique path never launched: {main}")
    # K4 builds each chunk's adjacency once, before the chunk's doublings
    # (the counters; the profiler may miss a window's first launch)
    check(main["build_local_adj"] == kc.LAUNCHES["build_local_adj"]
          == stats["chunks"],
          f"K4 launched {main['build_local_adj']} times (profiled call "
          f"{kc.LAUNCHES['build_local_adj']}) over {stats['chunks']} chunks")
    # K37 and K38 on the first chunk's levels, at the first caps and at the
    # caps that fit
    dag = orient.orient(g, rank)
    pg = PaddedGraph.from_csr(dag, device="cuda", lane=32)
    W, WW = pg.d_pad, pg.d_pad // 32
    # K4's bound over the whole call: each chunk at the global W, its rows
    # read and every output word written once (local_adj_bytes)
    every = np.nonzero(np.asarray(dag.degrees) >= k - 1)[0].astype(np.int32)
    k4_bytes = 0
    for at in range(0, len(every), 256):
        c = every[at:at + 256]
        c = np.concatenate([c, np.full(256 - len(c), pg.v_pad, np.int32)])
        k4_bytes += local_adj_bytes(pg, torch.from_numpy(c).cuda(), WW)
    print(f"[53] the warm call's K4: device {sums['K4'][0]:.4f} ms over "
          f"{sums['K4'][1]} launches, one a chunk ({stats['chunks']} chunks "
          f"at W={W}, {stats['doublings']} cap doublings); its bound over "
          f"the call's chunks {k4_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
          f"({k4_bytes} bytes) | {card_line()}")
    roots = every[:256]
    adj, S0 = kc.build_local_adj(pg.nbr, torch.from_numpy(roots).cuda(),
                                 w_words=WW)

    def levels(caps):
        """The levels of one run as the main path runs them, each with its
        inputs and the live count it was handed (None on the first)."""
        S = S0
        R = torch.arange(S0.shape[0], dtype=torch.int32, device="cuda")
        out, n = [], None
        for need, cap in zip(range(k - 2, 0, -1), caps):
            inputs = (S, R, n)
            S, R, n, _ = kc.expand_level(S, R, adj, cap=cap, need=need,
                                         n_live=n)
            out.append((inputs, cap, need, int(n)))
        return out, S

    caps = [max(256, 256 * W)] * (k - 2)
    first, _ = levels(caps)
    while True:
        last, S_last = levels(caps)
        if all(n <= cap for _, cap, _, n in last):
            break
        caps = [c * 2 for c in caps]
    check(any(n > cap for _, cap, _, n in first),
          "no level of the first chunk's first run has cap < n_children")
    rate = sm_rate(POPC_PER_CLOCK_PER_SM)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid1 = min(S0.numel(), 8 * sms)
    print(f"    K37's level 1: {S0.shape[0]} roots x {WW} words, a grid of "
          f"{grid1} blocks on {sms} SMs")
    check(grid1 >= sms, f"level 1 launches {grid1} blocks on {sms} SMs")
    held = {}
    for mode in ("without", "with"):
        k37 = []
        for run, lv in (("first", first), ("last", last)):
            for l, ((S, R, live), cap, need, n) in enumerate(lv):
                live = live if mode == "with" else None
                nbytes, ops = expand_bytes_ops(
                    S, R, adj, cap, None if live is None else int(live))
                k37.append((
                    f"{run} run, level {l + 1}: N={S.shape[0]} live="
                    f"{'N' if live is None else int(live)} cap={cap} "
                    f"need={need} n_children={n}",
                    lambda S=S, R=R, c=cap, d=need, v=live: kc.expand_level(
                        S, R, adj, cap=c, need=d, n_live=v),
                    lambda S=S, R=R, c=cap, d=need: kc.expand_level_plain(
                        S, R, adj, cap=c, need=d), nbytes, ops))
        held[mode] = compare(timing, k37, ops_rate=rate)
        err, k_ms, p_ms, bound_ms, by = held[mode]
        print(f"[53] expand_level {mode} the live count: {len(k37)} levels "
              f"of the first chunk (W={W}, {len(roots)} roots; caps "
              f"{caps[0]} after the doublings), max_abs_err {err}, kernel "
              f"{k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
              f"{p_ms:.4f} ms")
        check(err == 0, f"expand_level ({mode} the live count) disagrees "
                        f"with its plain version by {err}")
    report.append(kernel_entry("expand_level", main["expand_level"],
                               *held["with"]))
    # the zero fill apart: the held levels, live count passed, under the
    # profiler at their caps and at cap = min(cap, the survivors), which
    # leaves no zero row; alternated
    def held_levels(trim):
        for (S, R, live), cap, need, n in first + last:
            kc.expand_level(S, R, adj, cap=min(cap, n) if trim else cap,
                            need=need, n_live=live)

    split = {False: [], True: []}
    for trim in (False, True, True, False):
        _, _, pk, _ = profile_window(lambda: held_levels(trim))
        split[trim].append([round(pk[x][0] / 1e3, 4) if x in pk else 0.0
                            for x in K37_KERNELS])
    for trim, runs in split.items():
        print(f"    [53] the held levels at "
              f"{'cap = the survivors' if trim else 'their caps'}: device ms "
              f"{K37_KERNELS} {runs}")
    # the whole call's zero rows: each level's cap and survivors recorded
    seen, real = [], multi.expand_level

    def recording(S, R, adj, *, cap, need, n_live=None):
        out = real(S, R, adj, cap=cap, need=need, n_live=n_live)
        seen.append((cap, S.shape[1], out[2]))
        return out

    multi.expand_level = recording
    try:
        check(multi.sharded_kclique_count(g, k, mesh, rank=rank) == golden,
              "the recorded sharded call")
    finally:
        multi.expand_level = real
    kept = [(cap, ww, min(int(n), cap)) for cap, ww, n in seen]
    zero_b = sum((cap - m) * (ww + 1) * 4 for cap, ww, m in kept)
    live_b = sum(m * (ww + 1) * 4 for _, ww, m in kept)
    print(f"    [53] the warm sharded call's {len(kept)} levels write "
          f"{live_b} bytes of survivors' rows ({live_b / HBM_BYTES_PER_S * 1e3:.4f}"
          f" ms at 3.35 TB/s) and {zero_b} of zero rows "
          f"({zero_b / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    k38 = [(f"last level S {tuple(S_last.shape)}",
            lambda: kc.total_popcount(S_last),
            lambda: kc.total_popcount_plain(S_last), S_last.numel() * 4 + 8)]
    err, k_ms, p_ms, bound_ms, by = compare(timing, k38)
    print(f"[53] total_popcount: max_abs_err {err}, kernel {k_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({by}), plain {p_ms:.4f} ms")
    check(err == 0, f"total_popcount disagrees with its plain version by "
                    f"{err}")
    report.append(kernel_entry("total_popcount", main["total_popcount"], err,
                               k_ms, p_ms, bound_ms, by))
    del adj, S0, first, last, S_last, k37, k38

    # [54] the other sharded functions, and the world-size-1 counts of 55
    tc.reset_launches()
    t0 = time.perf_counter()
    tri = sharding.sharded_triangle_count(g18, mesh)
    tri_s = time.perf_counter() - t0
    print(f"[54] sharded_triangle_count RMAT {SCALE}: {tri}, golden {GOLDEN}, "
          f"{tri_s:.4f} s (host orient and pad included), count_dag_edges "
          f"launches {tc.LAUNCHES['count_dag_edges']}")
    check(tri == GOLDEN, f"sharded triangle count {tri} != {GOLDEN}")
    nbr, deg1, pairs = lp_pairs
    got = multi.sharded_pair_scores(mesh, metric="jaccard")(nbr, deg1, pairs)
    want = vs.pair_scores(nbr, deg1, pairs, metric="jaccard")
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    print(f"    sharded_pair_scores Jaccard on phase 30's {pairs.shape[0]} "
          f"pairs: bit for bit equal to pair_scores: {same}")
    check(same, "sharded_pair_scores differs from pair_scores")
    t0 = time.perf_counter()
    nbk = multi.sharded_bron_kerbosch_count(g14, ["cuda:0"])
    print(f"    sharded_bron_kerbosch_count RMAT {BK_SCALE} on cuda:0: {nbk}, "
          f"{time.perf_counter() - t0:.4f} s")
    check(nbk == BK_GOLDEN, f"sharded BK {nbk} != {BK_GOLDEN}")
    one = world_rank_counts(mesh)
    print(f"    world size 1 (NCCL): RMAT {MULTI_TC_SCALE} triangles "
          f"{one['tc']} ({one['tc_s']:.4f} s warm), RMAT {MULTI_KC_SCALE} "
          f"k={MULTI_K} {one['kc']} ({one['kc_s']:.4f} s warm)")
    check(one["tc"] == tc.triangle_count(build_csr(generate_rmat_el(
        MULTI_TC_SCALE, DEGREE, seed=SEED), num_nodes=1 << MULTI_TC_SCALE),
        device="cuda") and one["kc"] == kc.kclique_count(
            g12, MULTI_K, device="cuda"),
          "world size 1 differs from the single-device calls")
    dist.destroy_process_group()

    # [55] world size 2 over gloo, both ranks on this card
    t0 = time.perf_counter()
    ranks = world.spawn_world(world_rank_counts, 2, backend="gloo",
                              devices="cuda:0")
    spawn_s = time.perf_counter() - t0
    for r in ranks:
        print(f"[55] rank {r['rank']}/{r['size']} on {r['device']} (gloo): "
              f"triangles {r['tc']} ({r['tc_s']:.4f} s warm, world size 1 "
              f"{one['tc_s']:.4f} s), k-cliques {r['kc']} ({r['kc_s']:.4f} s "
              f"warm, world size 1 {one['kc_s']:.4f} s); collectives staged "
              f"through the host {r['staged']}")
        check(r["tc"] == one["tc"] and r["kc"] == one["kc"],
              f"world size 2 rank {r['rank']}: {r['tc']}, {r['kc']} != "
              f"{one['tc']}, {one['kc']}")
        check(r["staged"]["all_reduce"] > 0,
              f"gloo took CUDA tensors without staging: {r['staged']}")
    print(f"[55] two gloo ranks on one card agree with world size 1; spawn, "
          f"CUDA start-up and both runs {spawn_s:.2f} s; gloo takes the "
          f"8-byte counts through the host (staged explicitly)")


def all_launches() -> dict:
    """Every launch counter of the sharded plans' kernels, by wrapper."""
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.algorithms import triangle_count as tc
    return {**tc.LAUNCHES, **kc.LAUNCHES, **bk.LAUNCHES}


def reset_all_launches() -> None:
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.algorithms import triangle_count as tc
    for mod in (tc, kc, bk):
        mod.reset_launches()


# the kernels the sharded plans launch (phase 56)
RING_PATH = ("member_pack", "count_dag_edges_cross", "count_dag_edges",
             "count_hub_groups", "total_popcount", "kclique_dense_count",
             "kc_stack_count", "symmetrize_bits", "bk_stack_machine")


def ring_graphs():
    """Phases 56 and 58's graphs: RMAT 18 and the k-clique graphs of
    KCLIQUE_RUNS with their exact degeneracy ranks, and the k = 3 run on
    RMAT 12 (its golden the host triangle oracle); [(key, scale, k,
    golden, graph, rank)] with RMAT 18 as (..., None, None)."""
    from gms_tpu_torch.algorithms import triangle_count as tc
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.preprocessing import degeneracy

    def rmat(scale):
        return build_csr(generate_rmat_el(scale, DEGREE, seed=SEED),
                         num_nodes=1 << scale)

    out = [("rmat18", SCALE, None, GOLDEN, rmat(SCALE), None)]
    kgraphs = {}
    for scale, k, golden in KCLIQUE_RUNS + ((RING_K3_SCALE, 3, None),):
        if scale not in kgraphs:
            g = rmat(scale)
            kgraphs[scale] = (g, degeneracy.degeneracy_ordering_rank(g)[0])
        g, rank = kgraphs[scale]
        if golden is None:
            golden = tc.triangle_count_oracle(g)
        out.append((f"kc{scale}_{k}", scale, k, golden, g, rank))
    g, rank = kgraphs[BK_SMALL]
    out.append((f"bk{BK_SMALL}", BK_SMALL, None, BK_DIRECT_SMALL_GOLDEN, g,
                rank))
    return out


def ring_jobs(graphs):
    """[(key, golden, plan constructor of a mesh)] of phases 56 and 58."""
    from gms_tpu_torch.parallel import sharding as sh
    jobs = []
    for key, scale, k, golden, g, rank in graphs:
        if key == "rmat18":
            jobs.append(("tc_vertex", golden,
                         lambda m, g=g: sh.VertexShardedTrianglePlan(g, m)))
            jobs.append(("tc_tuned", golden,
                         lambda m, g=g: sh.ShardedTrianglePlan(g, m)))
        elif k is not None:
            chunk = RING_CHUNK16 if scale == 16 else RING_CHUNK
            jobs.append((key, golden, lambda m, g=g, k=k, r=rank, c=chunk:
                         sh.VertexShardedKCliquePlan(g, m, k=k, rank=r,
                                                     root_chunk=c)))
        else:
            jobs.append((key, golden, lambda m, g=g, r=rank:
                         sh.VertexShardedBKPlan(g, m, rank=r,
                                                root_chunk=RING_CHUNK)))
    return jobs


def run_ring_jobs(mesh, jobs, keep=()):
    """Build each plan on `mesh` and run it twice, the second timed warm:
    {key: {count, warm count, build_s, first_s, warm_s, launches (what the
    first run launched)}}, and the plans named in `keep`."""
    out, kept = {}, {}
    for key, golden, make in jobs:
        t0 = time.perf_counter()
        plan = make(mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        before = all_launches()
        t0 = time.perf_counter()
        got = plan.run()
        first_s = time.perf_counter() - t0
        after = all_launches()
        t0 = time.perf_counter()
        warm = plan.run()
        warm_s = time.perf_counter() - t0
        out[key] = {"count": got, "warm": warm, "golden": golden,
                    "build_s": build_s, "first_s": first_s,
                    "warm_s": warm_s,
                    "launches": {n: after[n] - before[n] for n in after
                                 if after[n] != before[n]}}
        if key in keep:
            kept[key] = plan
        del plan
    return out, kept


def ring_rank_counts(mesh):
    """Phase 58's run on one rank of a spawned world: every plan of phase
    56 on its graph, each twice (the second timed warm)."""
    out, _ = run_ring_jobs(mesh, ring_jobs(ring_graphs()))
    return {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
            "jobs": out, "staged": dict(mesh.staged)}


def row_words(table, rows) -> int:
    """Data words of the distinct `rows` of a padded table: each read up to
    and including its first SENTINEL, or whole when full."""
    from gms_tpu_torch.graphs.tiles import SENTINEL
    rows = torch.unique(rows.long())
    lens = (table[rows] != SENTINEL).sum(1)
    return int((lens + 1).clamp(max=table.shape[1]).sum())


def stop_row_words(table, rows, last) -> int:
    """Data words of the distinct `rows` of a padded table, each read up to
    and including its first entry past the largest of the `last` values it
    is walked against (a row's own SENTINEL passes every value)."""
    rows = rows.long().clamp(0, table.shape[0] - 1)
    u, inv = torch.unique(rows, return_inverse=True)
    top = torch.full((u.numel(),), -1, dtype=torch.long,
                     device=rows.device).scatter_reduce_(0, inv, last.long(),
                                                         "amax")
    below = (table[u].long() <= top[:, None]).sum(1)
    return int((below + 1).clamp(max=table.shape[1]).sum())


def pack_calls(plan, label, stops):
    """K39's (chunk, hop, pack) calls of a world-size-1 plan, each against
    its plain version on zeroed outputs (OR-ing again leaves them as they
    are, so the timed reps compute the same words). A call's bytes: each
    distinct visiting row a selected slot names and each q row with a
    selected slot, to its first SENTINEL; locs of the selected slots only;
    sel whole; the selected output words read and written. Appends to
    `stops` each call's bytes with the visiting rows read only to the
    entry past their root's last live value (stop_row_words), where the
    kernel's walk stops."""
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.graphs.tiles import SENTINEL
    calls = []
    vis = plan._own
    for ci, rc in enumerate(plan._chunks()):
        _live, q, valid, owner, locs, adj = plan._universe(rc)
        packs = [("adj", owner, locs, valid, adj.shape[1])]
        if hasattr(plan, "_lown"):
            _, wl = plan._root_rows(rc, plan._lown)
            w_owner, w_locs = plan._lookup(wl)
            packs.append(("M", w_owner, w_locs, wl != int(SENTINEL),
                          wl.shape[1]))
        for what, own, lc, v, L in packs:
            sel = (v & (own == 0)).contiguous()
            outs = [torch.zeros((q.shape[0], L, plan.w_words),
                                dtype=torch.int32, device=q.device)
                    for _ in range(2)]
            n_sel = int(sel.sum())
            rest = (row_words(q, sel.any(1).nonzero().reshape(-1))
                    + n_sel + 2 * n_sel * plan.w_words) * 4 + sel.numel()
            nbytes = row_words(vis, lc[sel]) * 4 + rest
            q_last = torch.where(q != int(SENTINEL), q, -1).amax(1)
            stops.append(stop_row_words(
                vis, lc[sel], q_last[sel.nonzero()[:, 0]]) * 4 + rest)
            calls.append((
                f"{label} chunk {ci} {what}: C={q.shape[0]} L={L} "
                f"selected {n_sel}",
                lambda q=q, lc=lc, sel=sel, o=outs[0]: kc.member_pack(
                    q, vis, lc, sel, o),
                lambda q=q, lc=lc, sel=sel, o=outs[1]:
                    kc.member_pack_plain(q, vis, lc, sel, o),
                nbytes))
    return calls


def ring_exact_checks(g18, plans) -> None:
    """Phase 57's checks beyond the world-size-1 workload, exact, untimed:
    K40 on RMAT 18 hash-owner split over two owners, with owner d's own
    shard and owner 1-d's as two tables (the kernel over all four buckets
    sums to the golden; the two cross buckets against plain), and each
    finish kernel of the ring path on the first ring-built chunk of its
    plan against its plain version."""
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.algorithms import triangle_count as tc
    from gms_tpu_torch.parallel import sharding
    from gms_tpu_torch.preprocessing import orient

    t0 = time.perf_counter()
    dag = orient.orient(g18, orient.degree_rank(g18))
    nbr = sharding._host_nbr(dag)
    table, owner, loc, _ = sharding._hash_owner_layout(nbr, 2)
    eb, vb, _ = sharding._edge_buckets(dag.edge_array(), owner, loc, 2, 1024,
                                       nbr.shape[1])
    table, eb, vb = (torch.from_numpy(x).cuda() for x in (table, eb, vb))
    del dag, nbr
    total = 0
    for d in range(2):
        for t in range(2):
            own, vis = table[d], table[(d + t) % 2]
            sched = tc.cross_schedule(eb[d, t], vb[d, t],
                                      tc.row_lengths(vis))
            got = tc.count_dag_edges_cross(own, vis, eb[d, t], vb[d, t],
                                           schedule=sched)
            total += int(got)
            if t:
                want = tc.count_dag_edges_cross_plain(own, vis, eb[d, t],
                                                      vb[d, t])
                err = max_abs_err(got, want)
                print(f"[57] count_dag_edges_cross, RMAT {SCALE} over two "
                      f"owners, bucket ({d}, 1): {int(vb[d, t].sum())} edges "
                      f"of owner {d}'s rows against owner {1 - d}'s, kernel "
                      f"{int(got)}, plain {int(want)}")
                check(err == 0, f"K40 two-table bucket ({d}, 1) disagrees "
                      f"with plain by {err}")
    print(f"[57] count_dag_edges_cross over the four buckets {total}, golden "
          f"{GOLDEN}; {time.perf_counter() - t0:.2f} s")
    check(total == GOLDEN, f"K40 over two owners: {total} != {GOLDEN}")
    del table, eb, vb

    def first(key):
        plan = plans[key]
        return plan._built(plan._chunks()[0])

    t0 = time.perf_counter()
    _, _, a3 = first(f"kc{RING_K3_SCALE}_3")
    _, _, a5 = first("kc16_5")
    _, v6, a6 = first("kc13_6")
    s6 = kc.pack_bits(v6)
    live, vbk, abk, M, wvalid = first(f"bk{BK_SMALL}")
    sym, sbk = bk.symmetrize_bits(abk), kc.pack_bits(vbk)
    finish = [
        ("total_popcount", f"RMAT {RING_K3_SCALE} k=3", a3,
         lambda: kc.total_popcount(a3), lambda: kc.total_popcount_plain(a3)),
        ("kclique_dense_count", "RMAT 16 k=5", a5,
         lambda: kc.kclique_dense_count(a5, k=5),
         lambda: kc.kclique_dense_count_plain(a5, k=5)),
        ("kc_stack_count", "RMAT 13 k=6", a6,
         lambda: kc.kc_stack_count(a6, s6, k=6),
         lambda: kc.kc_stack_count_plain(a6, s6, k=6)),
        ("symmetrize_bits", f"BK RMAT {BK_SMALL}", abk,
         lambda: bk.symmetrize_bits(abk),
         lambda: bk.symmetrize_bits_plain(abk)),
        ("bk_stack_machine", f"BK RMAT {BK_SMALL}, M {tuple(M.shape)}", sym,
         lambda: bk.bk_stack_machine(sym, sbk, live, M, wvalid),
         lambda: bk.bk_stack_machine_plain(sym, sbk, live, M, wvalid)),
    ]
    for name, label, adj, kernel, plain in finish:
        got, want = kernel(), plain()
        err = max_abs_err(got, want)
        value = f"{int(got)}" if got.dim() == 0 else f"{tuple(got.shape)}"
        print(f"[57] {name} on the first ring-built chunk, {label}, adj "
              f"{tuple(adj.shape)}: kernel {value}, max_abs_err {err}")
        check(err == 0, f"{name} on a ring-built chunk ({label}) disagrees "
              f"with plain by {err}")
    print(f"[57] finish kernels on ring-built chunks "
          f"{time.perf_counter() - t0:.2f} s")


def ring_phases(timing, report) -> None:
    """Phases 56-59: the ring-streamed and tuned sharded plans (see the
    module docstring)."""
    import torch.distributed as dist
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.algorithms import triangle_count as tc
    from gms_tpu_torch.parallel import dryrun, sharding, world

    # [56] world size 1 over NCCL, the main path of the sharded plans
    t_phase = time.perf_counter()
    graphs = ring_graphs()
    print(f"[56] graphs and degeneracy ranks on the host "
          f"{time.perf_counter() - t_phase:.2f} s")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    world.init_local("nccl")
    mesh = sharding.make_mesh()
    check(mesh.size == 1 and dist.get_backend() == "nccl",
          f"world of one over NCCL: size {mesh.size}")
    jobs = ring_jobs(graphs)
    reset_all_launches()
    one, plans = run_ring_jobs(
        mesh, jobs, keep=("tc_vertex", "kc16_5", "kc13_6",
                          f"kc{RING_K3_SCALE}_3", f"bk{BK_SMALL}"))
    # the launches of each plan's first run (the warm runs repeat them)
    main = {n: sum(r["launches"].get(n, 0) for r in one.values())
            for n in RING_PATH}
    by_key = {key: (g, rank, k) for key, _, k, _, g, rank in graphs}
    single = {}
    for key, r in one.items():
        if key.startswith("tc"):
            if "tc" not in single:
                p = tc.TrianglePlan(by_key["rmat18"][0], device="cuda",
                                    materialize=False)
                single["tc"] = (p.run(), warm(p.run)[1])
                del p
            ref = single["tc"]
        elif key.startswith("kc"):
            g, rank, k = by_key[key]
            ref = warm(lambda: kc.kclique_count(g, k, device="cuda",
                                                rank=rank))
        else:
            g, rank, _ = by_key[key]
            ref = warm(lambda: bk.bron_kerbosch(g, device="cuda", rank=rank))
        r["single"], r["single_s"] = ref
        print(f"[56] {key}: {r['count']} (warm {r['warm']}), golden "
              f"{r['golden']}; plan built in {r['build_s']:.3f} s, first run "
              f"{r['first_s']:.4f} s, warm {r['warm_s']:.4f} s; single-device"
              f" call {ref[0]} warm {ref[1]:.4f} s; launches {r['launches']}")
        check(r["count"] == r["warm"] == r["golden"] == ref[0],
              f"world size 1 {key}: {r['count']}, {r['warm']}, single "
              f"{ref[0]} != golden {r['golden']}")
    print(f"[56] launches of the sharded plans' first runs: {main}")
    check(all(v > 0 for v in main.values()),
          f"a kernel of the sharded plans never launched: {main}")

    # [57] K40 and K39 against their plain versions, exactly, on the
    # world-size-1 runs whose launches the kernels line counts
    tv = plans["tc_vertex"]
    own, eb, vb, sched = tv._own, tv._eb[0], tv._vb[0], tv._sched[0]
    used = eb[vb > 0]
    k40 = [(f"RMAT {SCALE} rotation 0: E={eb.shape[0]} D={own.shape[1]}, "
            f"{sched.items.shape[0]} items of at most {sched.span} edges",
            lambda: tc.count_dag_edges_cross(own, own, eb, vb,
                                             schedule=sched),
            lambda: tc.count_dag_edges_cross_plain(
                own, own, eb, vb, chunk=tv._chunk, method=tv._method),
            (row_words(own, used.reshape(-1)) + eb.numel() + vb.numel()) * 4
            + 8)]
    # the plain merge at D_pad 512 is a [1,024, 512, 512] compare a step
    err, k_ms, p_ms, bound_ms, by = compare(timing, k40, plain_reps=1)
    n40 = one["tc_vertex"]["launches"].get("count_dag_edges_cross", 0)
    sched_bytes = 4 * (sched.items.numel() + sched.vis.numel()
                       + sched.wt.numel() + sched.vlen.numel())
    print(f"[57] count_dag_edges_cross: {len(k40)} launch(es), the tc_vertex "
          f"run's {n40}; max_abs_err {err}, kernel {k_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}; the function's bytes), plain "
          f"{p_ms:.4f} ms; the schedule's own {sched_bytes} bytes "
          f"({sched_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms), built once with "
          f"the plan")
    check(err == 0, f"count_dag_edges_cross disagrees with plain by {err}")
    check(n40 == len(k40), f"K40 launches {n40} != its {len(k40)} calls")
    report.append(kernel_entry("count_dag_edges_cross", n40, err, k_ms, p_ms,
                               bound_ms, by))
    del own, eb, vb, used, k40, tv, sched
    stops = []
    k39 = (pack_calls(plans[f"bk{BK_SMALL}"], f"BK RMAT {BK_SMALL}", stops)
           + pack_calls(plans["kc13_6"], "RMAT 13 k=6", stops))
    n39 = sum(one[key]["launches"].get("member_pack", 0)
              for key in (f"bk{BK_SMALL}", "kc13_6"))
    err, k_ms, p_ms, bound_ms, by = compare(timing, k39)
    stop_b = sum(stops)
    print(f"[57] member_pack: {len(k39)} calls, the two runs' {n39} "
          f"launches; max_abs_err {err}, kernel {k_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}; each visiting row to its first "
          f"SENTINEL), to the entry past the root's last value "
          f"{stop_b / HBM_BYTES_PER_S * 1e3:.4f} ms ({stop_b} bytes), plain "
          f"{p_ms:.4f} ms | {card_line()}")
    check(err == 0, f"member_pack disagrees with plain by {err}")
    check(n39 == len(k39), f"K39 launches {n39} != its {len(k39)} calls")
    report.append(kernel_entry("member_pack", n39, err, k_ms, p_ms, bound_ms,
                               by))
    del k39
    ring_exact_checks(by_key["rmat18"][0], plans)
    del plans
    dist.destroy_process_group()
    print(f"[57] total of phases 56-57 {time.perf_counter() - t_phase:.1f} s")

    # [58] world size 2 over gloo, both ranks on this card
    t0 = time.perf_counter()
    ranks = world.spawn_world(ring_rank_counts, 2, backend="gloo",
                              devices="cuda:0")
    spawn_s = time.perf_counter() - t0
    for key in one:
        got = [r["jobs"][key] for r in ranks]
        print(f"[58] {key}: " + "; ".join(
            f"rank {r['rank']} {j['count']} (warm {j['warm']}), warm "
            f"{j['warm_s']:.4f} s" for r, j in zip(ranks, got))
            + f"; world size 1 warm {one[key]['warm_s']:.4f} s, single-device"
            f" {one[key]['single_s']:.4f} s")
        check(all(j["count"] == j["warm"] == one[key]["golden"]
                  for j in got),
              f"world size 2 {key}: {[j['count'] for j in got]} != "
              f"{one[key]['golden']}")
    for r in ranks:
        print(f"[58] rank {r['rank']}/{r['size']} on {r['device']} (gloo): "
              f"staged through the host {r['staged']}")
        check(r["staged"]["send_recv"] > 0 and r["staged"]["all_reduce"] > 0,
              f"gloo took CUDA tensors without staging: {r['staged']}")
    print(f"[58] two gloo ranks on one card agree with world size 1; spawn, "
          f"host layouts and both runs {spawn_s:.2f} s")

    # [59] the port's dry run, two ranks on this card
    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(2)
    print(f"[59] dryrun_multichip(2) on {torch.cuda.get_device_name(0)}: "
          f"{dry[0]}; {time.perf_counter() - t0:.2f} s")
    check(len(dry) == 2 and dry[0]["triangles"] == dry[1]["triangles"],
          f"dryrun_multichip(2): {dry}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this smoke test runs only on a GPU")
    from gms_tpu_torch import _kernels
    from gms_tpu_torch.algorithms import triangle_count as tc
    from gms_tpu_torch.graphs.tiles import SENTINEL
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {kind} | nvidia-smi: {card} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = _kernels.build()
    print(f"[1] build: {len(reports)} libraries in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas {name}: {line.strip()}")
    # [2] headline graph (host)
    t0 = time.perf_counter()
    g = build_csr(generate_rmat_el(SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << SCALE)
    print(f"[2] graph: RMAT scale {SCALE} deg {DEGREE} seed {SEED}: "
          f"{g.num_nodes} nodes, {g.num_edges_undirected} undirected edges, "
          f"max degree {g.max_degree}, {time.perf_counter() - t0:.2f} s")

    # [3] main path through the user's entry points, counters from 0
    tc.reset_launches()
    t0 = time.perf_counter()
    plan = tc.TrianglePlan(g, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    count = plan.run()
    gplan = tc.TrianglePlan(g, device="cuda", materialize=False)
    gcount = gplan.run()
    launches = {n: tc.LAUNCHES[n] for n in TC_PATH}
    print(f"[3] main path: materialized plan built in {build_s:.2f} s, "
          f"count {count}; gather plan count {gcount}; golden {GOLDEN}; "
          f"launches {launches}")
    check(plan.tiers_mat is not None, "the headline plan is not materialized")
    check(count == GOLDEN, f"materialized count {count} != {GOLDEN}")
    check(gcount == GOLDEN, f"gather-mode count {gcount} != {GOLDEN}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    print(f"    D_pad {plan.padded.d_pad}, V_pad {plan.padded.v_pad}, "
          f"traffic_bytes {plan.traffic_bytes()}")
    for wa, wb, c, edges, valid in plan.tiers:
        print(f"    tier ({wa},{wb}): {int(valid.sum())} edges, padded "
              f"{valid.numel()}")
    for w, k, gc, b_ids, nbrs in plan.hub or []:
        print(f"    hub group (W={w},K={k}): {b_ids.numel()} groups")
    print(f"    hub rows {tuple(plan.hub_rows.shape)}")

    # [4] each kernel against its plain version, exactly, at these shapes
    timing = Timing()
    rows, nbr, deg = plan.hub_rows, plan.padded.nbr, plan.padded.deg
    guard = rows.shape[0] - 1
    wide = plan.wide_ids
    wide_rows = nbr[wide.long()]
    # hub_id entries K3 looks up: each distinct neighbour and the clip slot
    looked_up = (torch.unique(wide_rows[wide_rows != SENTINEL]).numel()
                 + int((wide_rows == SENTINEL).any()))
    del wide_rows
    gdeg, gguard = gplan.padded.deg, gplan.hub_rows.shape[0] - 1
    calls = {
        "count_tier_mat": [
            (f"({a.shape[0]},{b.shape[0]}) E={a.shape[1]}",
             lambda a=a, b=b: tc.count_tier_mat(a, b),
             lambda a=a, b=b, cm=cm: tc.count_tier_mat_plain(a, b, chunk=cm),
             (data_words(deg, e[v > 0, 0], wa)
              + data_words(deg, e[v > 0, 1], wb)) * 4 + 8)
            for (wa, wb, c, e, v), (cm, a, b) in zip(plan.tiers,
                                                      plan.tiers_mat)],
        "count_hub_groups_mat": [
            (f"(W={b.shape[1]},K={a.shape[1]}) G={b.shape[0]}",
             lambda a=a, b=b: tc.count_hub_groups_mat(b, a),
             lambda a=a, b=b, gc=gc: tc.count_hub_groups_mat_plain(
                 b, a, chunk=gc),
             int((b_ids != guard).sum() + (nbrs != guard).sum()) * w * 4 + 8)
            for (w, k, _, b_ids, nbrs), (gc, b, a) in zip(plan.hub,
                                                           plan.hub_mat)],
        "build_hub_rows": [
            (f"Nw={wide.numel()} hw={rows.shape[1]}",
             lambda: tc.build_hub_rows(nbr, plan.hub_id, wide,
                                       hub_words=rows.shape[1]),
             lambda: tc.build_hub_rows_plain(nbr, plan.hub_id, wide,
                                             hub_words=rows.shape[1]),
             (data_words(deg, wide, nbr.shape[1]) + wide.numel() + looked_up
              + wide.numel() * rows.shape[1]) * 4)],
        "count_dag_edges": [
            (f"({wa},{wb}) E={e.shape[0]}",
             lambda e=e, v=v, wa=wa, wb=wb: tc.count_dag_edges(
                gplan.padded.nbr, e, v, width_a=wa, width_b=wb),
             lambda e=e, v=v, wa=wa, wb=wb, c=c: tc.count_dag_edges_plain(
                 gplan.padded.nbr, e, v, chunk=c, width_a=wa, width_b=wb),
             (distinct_data_words(gdeg, [(e[v > 0, 0], wa), (e[v > 0, 1], wb)])
              + e.numel() + v.numel()) * 4 + 8)
            for wa, wb, c, e, v in gplan.tiers],
        "count_hub_groups": [
            (f"(W={w},K={k}) G={b.shape[0]}",
             lambda b=b, n=n, w=w, k=k, gc=gc: tc.count_hub_groups(
                gplan.hub_rows, b, n, chunk=gc, width=w, k=k),
             lambda b=b, n=n, w=w, k=k, gc=gc: tc.count_hub_groups_plain(
                 gplan.hub_rows, b, n, chunk=gc, width=w, k=k),
             (distinct_rows(gguard, b, n) * w + b.numel() + n.numel()) * 4 + 8)
            for w, k, gc, b, n in gplan.hub],
    }
    report, bounds = [], {}
    for name, kcalls in calls.items():
        err, k_ms, p_ms, bound_ms, by = compare(timing, kcalls)
        print(f"[4] {name}: {len(kcalls)} launches/trial, max_abs_err {err}, "
              f"kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
              f"plain {p_ms:.4f} ms")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        bounds[name] = bound_ms
        report.append(kernel_entry(name, launches[name], err, k_ms, p_ms,
                                   bound_ms, by))

    # [5] steady state
    for label, p, kernels in (
            ("materialized", plan, ("count_tier_mat", "count_hub_groups_mat")),
            ("gather", gplan, ("count_dag_edges", "count_hub_groups"))):
        cnt, dt = p.run_steady(STEADY_TRIALS)
        modelled_ms = p.traffic_bytes() / HBM_BYTES_PER_S * 1e3
        bound_ms = sum(bounds[k] for k in kernels)
        print(f"[5] steady {label}: count {cnt}, {dt * 1e3:.4f} ms/trial over "
              f"{STEADY_TRIALS} trials, {g.num_edges_undirected / dt:.1f} "
              f"edges/s, bound {bound_ms:.4f} ms (sum of the launches'), "
              f"traffic_bytes() at 3.35 TB/s {modelled_ms:.4f} ms")
        check(cnt == GOLDEN, f"steady {label} count {cnt} != {GOLDEN}")
    del plan, gplan, calls
    # K40 over a warm vertex-sharded run at a world of one (no process
    # group; phase 56 runs the plan over NCCL), under torch.profiler
    from gms_tpu_torch.bench.profiling import profile_window, window_lines
    from gms_tpu_torch.parallel import sharding
    vplan = sharding.VertexShardedTrianglePlan(g, sharding.make_mesh())
    check(vplan.run() == GOLDEN, "the vertex-sharded run's count")
    got, host_s, per, busy = profile_window(vplan.run)
    check(got == GOLDEN, f"the profiled vertex-sharded run: {got}")
    sums = window_lines("[5] warm VertexShardedTrianglePlan.run, a world of "
                        "one, under torch.profiler:", host_s, per, busy,
                        {"K40": ("owned_rows_kernel",)})
    check(sums["K40"][1] == 1, "the profiled vertex-sharded run traced "
          f"{sums['K40'][1]} K40 launches")
    print(f"    [5] | {card_line()}")
    del vplan

    # [6] small graph against the host oracle
    small = build_csr(generate_rmat_el(12, 16, seed=SEED), num_nodes=1 << 12)
    want = tc.triangle_count_oracle(small)
    got = tc.triangle_count(small, device="cuda")
    check(got == want, f"RMAT-12 triangle_count {got} != oracle {want}")
    for t in (8, 65, None):
        for mat in (True, False):
            got = tc.TrianglePlan(small, device="cuda", hub_threshold=t,
                                  materialize=mat).run()
            check(got == want, f"RMAT-12 hub_threshold={t} materialize={mat}:"
                               f" {got} != oracle {want}")
    print(f"[6] RMAT-12 oracle {want}: triangle_count and hub thresholds "
          f"8/65/None in both modes agree")

    print(f"[7] launches on the main path: {launches}; total "
          f"{time.perf_counter() - t_start:.1f} s")
    kclique_phases(timing, report)
    print(f"[11] total so far {time.perf_counter() - t_start:.1f} s")
    bk_phases(timing, report)
    print(f"[16] total so far {time.perf_counter() - t_start:.1f} s")
    star_phases(timing, report)
    print(f"[22] total so far {time.perf_counter() - t_start:.1f} s")
    vertex_phases(timing, report, g)
    print(f"[29] total so far {time.perf_counter() - t_start:.1f} s")
    lp_pairs = lp_phases(timing, report)
    print(f"[36] total so far {time.perf_counter() - t_start:.1f} s")
    coloring_phases(timing, report)
    print(f"[41] total so far {time.perf_counter() - t_start:.1f} s")
    g14 = build_csr(generate_rmat_el(VF2_SCALE, DEGREE, seed=SEED),
                    num_nodes=1 << VF2_SCALE)
    recorded = vf2_phases(g14)
    print(f"[44] total so far {time.perf_counter() - t_start:.1f} s")
    forms = compressed_phases(timing, report, g14, recorded)
    print(f"[46] total so far {time.perf_counter() - t_start:.1f} s")
    gapbs_phases(timing, report, g, g14, forms)
    print(f"[50] total so far {time.perf_counter() - t_start:.1f} s")
    del forms
    g12, rank12 = direct_phases(timing, report, g14)
    print(f"[52] total so far {time.perf_counter() - t_start:.1f} s")
    multi_phases(timing, report, g, g14, g12, lp_pairs)
    print(f"[55] total so far {time.perf_counter() - t_start:.1f} s")
    ring_phases(timing, report)
    print(f"[59] total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
