// K10 decode_clique_members: emitted Bron-Kerbosch rows -> member ids.
//
// Replaces gms_tpu/algorithms/bron_kerbosch.py:832 decode_clique_members.
// A row of out (int32[L, WW+1]) is (Rbits[WW] | root-local index). With
// W = 32*WW, g = chunk[clip(out[l, WW], 0, C-1)] and the root's slots
// q[j] = nbr[clip(g, 0, V_pad-1), j] for j < min(W, D), SENTINEL beyond:
//   gid[l]        = g
//   members[l, j] = q[j] if bit j of Rbits is set and q[j] != SENTINEL,
//                   else -1
// A warp a row, 16-byte stores: row_decode.cuh with one bit block, whose
// header gives the design and the bound.

#include "row_decode.cuh"

extern "C" int decode_clique_members(const void* nbr, long long v_pad, int d,
                                     const void* chunk, long long c,
                                     const void* out, long long l_rows, int ww,
                                     void* gid, void* members, void* stream) {
  return decode_rows<1>(nbr, v_pad, d, chunk, c, out, l_rows, ww, gid,
                        members, stream);
}
