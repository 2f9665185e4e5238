// K3 and K4, the flash-attention backward (flash_bwd.cuh), at the wide
// widths 160, 192, 224 and 256 (exact at 256): K3 one CTA per q tile, K4
// two per key tile, one per half of dK's and dV's columns. A translation
// unit of its own, so that it compiles beside flash_bwd.cu, which calls it.
#include "flash_bwd.cuh"

// The exact instantiation at 256, else the padded wide one of pad_dim(D).
#define DL4J_BWD_WIDE_SWITCH(LAUNCH)                                        \
  if (D == 256) {                                                           \
    switch (D) { DL4J_BWD_CASE(256, false, LAUNCH) }                        \
  }                                                                         \
  switch (dl4j::pad_dim(D)) {                                               \
    DL4J_BWD_CASE(160, true, LAUNCH)                                        \
    DL4J_BWD_CASE(192, true, LAUNCH)                                        \
    DL4J_BWD_CASE(224, true, LAUNCH)                                        \
    DL4J_BWD_CASE(256, true, LAUNCH)                                        \
    default:                                                                \
      return -2;                                                            \
  }

// dl4j_flash_bwd_dq for a head dim of 129..256
extern "C" int dl4j_flash_bwd_dq_wide(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      const float* mask, void* dq, int B,
                                      int H, int Tlen, int D, int dtype,
                                      int causal, cudaStream_t stream) {
  void* out0 = dq;
  void* out1 = nullptr;
  DL4J_BWD_WIDE_SWITCH(launch_dq)
}

// dl4j_flash_bwd_dkv for a head dim of 129..256
extern "C" int dl4j_flash_bwd_dkv_wide(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       const float* mask, void* dk, void* dv,
                                       int B, int H, int Tlen, int D,
                                       int dtype, int causal,
                                       cudaStream_t stream) {
  void* out0 = dk;
  void* out1 = dv;
  DL4J_BWD_WIDE_SWITCH(launch_dkv)
}

#undef DL4J_BWD_WIDE_SWITCH

// dl4j_flash_bwd_smem at the wide widths
extern "C" int dl4j_flash_bwd_wide_smem(int D, int dtype) {
  switch (dl4j::pad_dim(D)) {
    DL4J_BWD_SMEM(160)
    DL4J_BWD_SMEM(192)
    DL4J_BWD_SMEM(224)
    DL4J_BWD_SMEM(256)
    default:
      return -2;
  }
}
