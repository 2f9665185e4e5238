// K3 and K4, the flash-attention backward (flash_bwd.cuh): K3 at the widths
// up to 128 and the C entry points of K3 and of the kernels' shared
// memory; K4 at the widths up to 128 is in flash_bwd_dkv.cu, both at the
// wide widths in flash_bwd_wide.cu (translation units compiled in
// parallel).
#include "flash_bwd.cuh"

// flash_bwd_wide.cu: K3 at a head dim of 129..256 (the arguments and
// return codes of dl4j_flash_bwd_dq), and the wide widths' shared memory
extern "C" int dl4j_flash_bwd_dq_wide(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      const float* mask, void* dq, int B,
                                      int H, int Tlen, int D, int dtype,
                                      int causal, cudaStream_t stream);
extern "C" int dl4j_flash_bwd_wide_smem(int D, int dtype);

// Launch K3 (dq into out0) on `stream`; 0 after a launch (the caller checks
// it with cudaGetLastError), nonzero for an unsupported configuration,
// which launches nothing. dtype as for DL4J_BWD_CASE.
extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const float* mask,
                                 void* dq, int B, int H, int Tlen, int D,
                                 int dtype, int causal,
                                 cudaStream_t stream) {
  if (Tlen < 1 || B * H < 1 || B * H > 65535) return -1;
  if (dl4j::pad_dim(D) > 128)
    return dl4j_flash_bwd_dq_wide(q, k, v, dout, lse, delta, mask, dq, B, H,
                                  Tlen, D, dtype, causal, stream);
  void* out0 = dq;
  void* out1 = nullptr;
  DL4J_BWD_SWITCH(launch_dq)
}

// Dynamic shared memory of one K3 or K4 CTA in bytes (the two kernels'
// layouts take the same size; for reports) at the width a head dim D runs
// at; dtype as for dl4j_flash_bwd_dq; -2 for a head dim no kernel takes.
extern "C" int dl4j_flash_bwd_smem(int D, int dtype) {
  if (dl4j::pad_dim(D) > 128) return dl4j_flash_bwd_wide_smem(D, dtype);
  switch (dl4j::pad_dim(D)) {
    DL4J_BWD_SMEM(8)
    DL4J_BWD_SMEM(16)
    DL4J_BWD_SMEM(32)
    DL4J_BWD_SMEM(48)
    DL4J_BWD_SMEM(64)
    DL4J_BWD_SMEM(80)
    DL4J_BWD_SMEM(96)
    DL4J_BWD_SMEM(128)
    default:
      return -2;
  }
}
