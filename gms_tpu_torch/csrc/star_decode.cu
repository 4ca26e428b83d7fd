// K13 decode_star_rows: emitted k-clique-star rows -> member and star ids.
//
// Replaces gms_tpu/algorithms/k_clique_star.py:346 decode_star_rows. A row
// of out (int32[L, 2*WW+1]) is (Rbits[WW] | starbits[WW] | root-local index),
// as star_stack.cu writes it. With W = 32*WW, g = chunk[clip(out[l, 2*WW],
// 0, C-1)] and the root's undirected slots q[j] = nbr[clip(g, 0, V_pad-1), j]
// for j < min(W, D), SENTINEL beyond:
//   gid[l]        = g
//   ids[0, l, j]  = q[j] if bit j of Rbits is set and q[j] != SENTINEL,
//                   else -1 (the clique's members besides g)
//   ids[1, l, j]  = the same for starbits (the star)
// A warp a row writing both ids, 16-byte stores: row_decode.cuh with two bit
// blocks, whose header gives the design and the bound.

#include "row_decode.cuh"

extern "C" int decode_star_rows(const void* nbr, long long v_pad, int d,
                                const void* chunk, long long c,
                                const void* out, long long l_rows, int ww,
                                void* gid, void* ids, void* stream) {
  return decode_rows<2>(nbr, v_pad, d, chunk, c, out, l_rows, ww, gid, ids,
                        stream);
}
