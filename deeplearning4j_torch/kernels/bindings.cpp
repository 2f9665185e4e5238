// PyTorch bindings of the port's kernels: the only source that includes
// PyTorch's headers (they dominate the build time). Each entry checks its
// tensors, allocates the outputs, launches on PyTorch's current stream and
// checks the launch with C10_CUDA_KERNEL_LAUNCH_CHECK().
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              const float* mask, void* o, float* lse, int B,
                              int H, int Tlen, int D, int is_bf16, int causal,
                              cudaStream_t stream);
extern "C" int dl4j_paged_attn_splits(int B, int H, int T, int D, int ps,
                                      int NP, int kind);
extern "C" int dl4j_paged_chunk_smem(int D, int kind, int NP);
extern "C" int dl4j_paged_attn(const void* q, const void* kp, const void* vp,
                               const float* kscales, const float* vscales,
                               const int* bt, const int* pos,
                               const float* key_valid, void* o, float* part,
                               int splits, int B, int H, int T, int D, int ps,
                               int NP, int qtype, int quant,
                               cudaStream_t stream);
extern "C" int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const float* mask,
                                 void* dq, int B, int H, int Tlen, int D,
                                 int is_bf16, int causal, cudaStream_t stream);
extern "C" int dl4j_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const float* mask,
                                  void* dk, void* dv, int B, int H, int Tlen,
                                  int D, int is_bf16, int causal,
                                  cudaStream_t stream);

namespace {

void check_cuda(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

const float* opt_f32(const c10::optional<torch::Tensor>& t, const char* name,
                     at::IntArrayRef shape) {
  if (!t.has_value()) return nullptr;
  check_cuda(*t, name);
  TORCH_CHECK(t->scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(t->sizes() == shape, name, " has shape ", t->sizes(),
              ", expected ", shape);
  return t->data_ptr<float>();
}

std::vector<torch::Tensor> flash_fwd(torch::Tensor q, torch::Tensor k,
                                     torch::Tensor v,
                                     c10::optional<torch::Tensor> mask,
                                     bool causal) {
  check_cuda(q, "q");
  check_cuda(k, "k");
  check_cuda(v, "v");
  TORCH_CHECK(q.dim() == 4, "q must be [B, H, T, d]");
  TORCH_CHECK(k.sizes() == q.sizes() && v.sizes() == q.sizes(),
              "q, k, v shapes differ");
  const auto dt = q.scalar_type();
  TORCH_CHECK(dt == torch::kFloat32 || dt == torch::kBFloat16,
              "flash_fwd takes float32 or bfloat16");
  TORCH_CHECK(k.scalar_type() == dt && v.scalar_type() == dt,
              "q, k, v dtypes differ");
  const int B = q.size(0), H = q.size(1), T = q.size(2), D = q.size(3);
  const float* m = opt_f32(mask, "mask", {B, T});
  const c10::cuda::CUDAGuard guard(q.device());
  auto o = torch::empty_like(q);
  auto lse = torch::empty({(int64_t)B * H, T, 1},
                          q.options().dtype(torch::kFloat32));
  const int err = dl4j_flash_fwd(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), m, o.data_ptr(),
      lse.data_ptr<float>(), B, H, T, D, dt == torch::kBFloat16 ? 1 : 0,
      causal ? 1 : 0, at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "flash_fwd: unsupported configuration (B=", B,
              ", H=", H, ", T=", T, ", d=", D, "), code ", err);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {o, lse};
}

torch::Tensor paged_attn(torch::Tensor q, torch::Tensor kp, torch::Tensor vp,
                         c10::optional<torch::Tensor> kscales,
                         c10::optional<torch::Tensor> vscales,
                         torch::Tensor bt, torch::Tensor pos,
                         c10::optional<torch::Tensor> key_valid,
                         int64_t splits) {
  check_cuda(q, "q");
  check_cuda(kp, "kpages");
  check_cuda(vp, "vpages");
  check_cuda(bt, "block_table");
  check_cuda(pos, "cache_pos");
  const auto qt = q.scalar_type();
  TORCH_CHECK(q.dim() == 4 && (qt == torch::kFloat32 ||
                               qt == torch::kBFloat16 || qt == torch::kHalf),
              "q must be float32, bfloat16 or float16 [B, H, T, d]");
  TORCH_CHECK(kp.dim() == 4 && vp.sizes() == kp.sizes(),
              "pools must be [P, H, ps, d] of one shape");
  const bool quant = kp.scalar_type() == torch::kInt8;
  TORCH_CHECK(quant || kp.scalar_type() == qt,
              "pools must be of q's dtype or int8");
  TORCH_CHECK(vp.scalar_type() == kp.scalar_type(), "pool dtypes differ");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(kp.data_ptr()) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(vp.data_ptr()) % 16 == 0,
              "pools must be 16-byte aligned (the kernel copies 16 bytes at "
              "a time)");
  const int B = q.size(0), H = q.size(1), T = q.size(2), D = q.size(3);
  const int P = kp.size(0), ps = kp.size(2);
  TORCH_CHECK(kp.size(1) == H && kp.size(3) == D,
              "pool heads/head dim differ from q");
  TORCH_CHECK(bt.dim() == 2 && bt.size(0) == B &&
                  bt.scalar_type() == torch::kInt32,
              "block_table must be int32 [B, NP]");
  TORCH_CHECK(pos.dim() == 1 && pos.size(0) == B &&
                  pos.scalar_type() == torch::kInt32,
              "cache_pos must be int32 [B]");
  const int NP = bt.size(1);
  const float* ks = nullptr;
  const float* vs = nullptr;
  if (quant) {
    TORCH_CHECK(kscales.has_value() && vscales.has_value(),
                "int8 pools need kscales and vscales");
    ks = opt_f32(kscales, "kscales", {P, H, ps});
    vs = opt_f32(vscales, "vscales", {P, H, ps});
  }
  const float* kv = opt_f32(key_valid, "key_valid", {B, (int64_t)NP * ps});
  const c10::cuda::CUDAGuard guard(q.device());
  // 0 lets the kernel's rule pick the chunk route's split count; a caller
  // may force one (1: no split) to compare the two walks
  const int kind = quant ? 1 : (qt == torch::kFloat32 ? 0 : 2);
  if (splits <= 0) splits = dl4j_paged_attn_splits(B, H, T, D, ps, NP, kind);
  TORCH_CHECK(splits == 1 || (T > 4 && splits <= 1024),
              "paged_attn: splits must be 1 for T <= 4 and at most 1024");
  auto o = torch::empty_like(q);
  // the split route's workspace: per split, each row's f32 accumulators,
  // m, l
  torch::Tensor part;
  if (splits > 1)
    part = torch::empty({splits * B * H * T * (int64_t)(D + 2)},
                        q.options().dtype(torch::kFloat32));
  const int err = dl4j_paged_attn(
      q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks, vs, bt.data_ptr<int>(),
      pos.data_ptr<int>(), kv, o.data_ptr(),
      splits > 1 ? part.data_ptr<float>() : nullptr, (int)splits, B, H, T, D,
      ps, NP, qt == torch::kFloat32 ? 0 : (qt == torch::kBFloat16 ? 1 : 2),
      quant ? 1 : 0, at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "paged_attn: unsupported configuration (B=", B,
              ", H=", H, ", T=", T, ", d=", D, ", ps=", ps, ", NP=", NP,
              ", splits=", splits, "), code ", err);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return o;
}

// Checks shared by the two backward kernels: q, k, v, dO of one shape and
// type (f32 or bf16), lse and delta f32 [B·H, T, 1], an optional f32 [B, T]
// key mask. Returns the mask pointer (or nullptr).
const float* check_bwd(const torch::Tensor& q, const torch::Tensor& k,
                       const torch::Tensor& v, const torch::Tensor& dout,
                       const torch::Tensor& lse, const torch::Tensor& delta,
                       const c10::optional<torch::Tensor>& mask) {
  check_cuda(q, "q");
  check_cuda(k, "k");
  check_cuda(v, "v");
  check_cuda(dout, "dout");
  TORCH_CHECK(q.dim() == 4, "q must be [B, H, T, d]");
  TORCH_CHECK(k.sizes() == q.sizes() && v.sizes() == q.sizes() &&
                  dout.sizes() == q.sizes(),
              "q, k, v, dout shapes differ");
  const auto dt = q.scalar_type();
  TORCH_CHECK(dt == torch::kFloat32 || dt == torch::kBFloat16,
              "flash backward takes float32 or bfloat16");
  TORCH_CHECK(k.scalar_type() == dt && v.scalar_type() == dt &&
                  dout.scalar_type() == dt,
              "q, k, v, dout dtypes differ");
  const int B = q.size(0), H = q.size(1), T = q.size(2);
  opt_f32(lse, "lse", {(int64_t)B * H, T, 1});
  opt_f32(delta, "delta", {(int64_t)B * H, T, 1});
  return opt_f32(mask, "mask", {B, T});
}

torch::Tensor flash_bwd_dq(torch::Tensor q, torch::Tensor k, torch::Tensor v,
                           torch::Tensor dout, torch::Tensor lse,
                           torch::Tensor delta,
                           c10::optional<torch::Tensor> mask, bool causal) {
  const float* m = check_bwd(q, k, v, dout, lse, delta, mask);
  const int B = q.size(0), H = q.size(1), T = q.size(2), D = q.size(3);
  const c10::cuda::CUDAGuard guard(q.device());
  auto dq = torch::empty_like(q);
  const int err = dl4j_flash_bwd_dq(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), m, dq.data_ptr(), B, H,
      T, D, q.scalar_type() == torch::kBFloat16 ? 1 : 0, causal ? 1 : 0,
      at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "flash_bwd_dq: unsupported configuration (B=", B,
              ", H=", H, ", T=", T, ", d=", D, "), code ", err);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return dq;
}

std::vector<torch::Tensor> flash_bwd_dkv(torch::Tensor q, torch::Tensor k,
                                         torch::Tensor v, torch::Tensor dout,
                                         torch::Tensor lse,
                                         torch::Tensor delta,
                                         c10::optional<torch::Tensor> mask,
                                         bool causal) {
  const float* m = check_bwd(q, k, v, dout, lse, delta, mask);
  const int B = q.size(0), H = q.size(1), T = q.size(2), D = q.size(3);
  const c10::cuda::CUDAGuard guard(q.device());
  auto dk = torch::empty_like(k);
  auto dv = torch::empty_like(v);
  const int err = dl4j_flash_bwd_dkv(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), m, dk.data_ptr(),
      dv.data_ptr(), B, H, T, D, q.scalar_type() == torch::kBFloat16 ? 1 : 0,
      causal ? 1 : 0, at::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "flash_bwd_dkv: unsupported configuration (B=", B,
              ", H=", H, ", T=", T, ", d=", D, "), code ", err);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {dk, dv};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_fwd", &flash_fwd, "K1: flash-attention forward (o, lse)");
  m.def("paged_attn", &paged_attn, "K2: paged-KV attention read",
        py::arg("q"), py::arg("kp"), py::arg("vp"), py::arg("kscales"),
        py::arg("vscales"), py::arg("bt"), py::arg("pos"),
        py::arg("key_valid"), py::arg("splits") = 0);
  m.def("paged_attn_splits", &dl4j_paged_attn_splits,
        "K2: the chunk route's split count for (B, H, T, d, ps, NP, kind), "
        "kind the pools' element (0 f32, 1 int8, 2 bf16/f16); 1 means one "
        "pass, no merge");
  m.def("paged_chunk_smem", &dl4j_paged_chunk_smem,
        "K2: dynamic shared memory of one chunk-route CTA for (d, kind, NP), "
        "in bytes (kind as for paged_attn_splits)");
  m.def("flash_bwd_dq", &flash_bwd_dq, "K3: flash-attention backward, dq");
  m.def("flash_bwd_dkv", &flash_bwd_dkv,
        "K4: flash-attention backward, (dk, dv)");
}
