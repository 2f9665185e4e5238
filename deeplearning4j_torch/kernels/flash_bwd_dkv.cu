// K4, the flash-attention backward's dK/dV (flash_bwd.cuh), at the widths up
// to 128, and its C entry point; the wide widths are in flash_bwd_wide.cu.
// A translation unit of its own, so that it compiles beside flash_bwd.cu.
#include "flash_bwd.cuh"

// flash_bwd_wide.cu: K4 at a head dim of 129..256, the arguments and
// return codes of dl4j_flash_bwd_dkv
extern "C" int dl4j_flash_bwd_dkv_wide(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       const float* mask, void* dk, void* dv,
                                       int B, int H, int Tlen, int D,
                                       int dtype, int causal,
                                       cudaStream_t stream);

// Launch K4 (dk into out0, dv into out1) on `stream`; return codes as
// dl4j_flash_bwd_dq's (flash_bwd.cu).
extern "C" int dl4j_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const float* mask,
                                  void* dk, void* dv, int B, int H, int Tlen,
                                  int D, int dtype, int causal,
                                  cudaStream_t stream) {
  if (Tlen < 1 || B * H < 1 || B * H > 65535) return -1;
  if (dl4j::pad_dim(D) > 128)
    return dl4j_flash_bwd_dkv_wide(q, k, v, dout, lse, delta, mask, dk, dv,
                                   B, H, Tlen, D, dtype, causal, stream);
  void* out0 = dk;
  void* out1 = dv;
  DL4J_BWD_SWITCH(launch_dkv)
}

