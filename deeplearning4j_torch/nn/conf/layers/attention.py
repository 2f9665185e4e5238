"""Attention layers (port of
``deeplearning4j_tpu/nn/conf/layers/attention.py``): ``scaled_dot_attention``,
``SelfAttentionLayer`` (the full-sequence forward, the dense KV-cache
streaming forward behind ``rnn_time_step`` and the generate loops, and the
paged-KV serving forward) and ``PositionalEncodingLayer``.

The tensor-parallel paged path and dense streaming with per-row positions
(the JAX package's slot-pooled stock decode) are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from deeplearning4j_torch.nn.conf.layers import paged_attention as ppa
from deeplearning4j_torch.nn.conf.layers.base import BaseLayer, Layer
from deeplearning4j_torch.ops import flash_attention as fa
from deeplearning4j_torch.utils.serde import register_serializable

NEG_INF = -1e30


def scaled_dot_attention(q, k, v, *, causal: bool = False, mask=None):
    """softmax(q kᵀ / sqrt(d)) v over [..., T, d] tensors.

    mask: [B, T] validity of the KEY positions (broadcast over heads).
    """
    d = q.shape[-1]
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    T_q, T_k = logits.shape[-2], logits.shape[-1]
    if causal:
        keep = torch.ones(T_q, T_k, dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    if mask is not None:
        key_mask = (mask != 0)[:, None, None, :]
        logits = torch.where(key_mask, logits,
                             torch.full_like(logits, NEG_INF))
    return torch.matmul(torch.softmax(logits, dim=-1), v)


@register_serializable
@dataclass
class SelfAttentionLayer(BaseLayer):
    """Multi-head self-attention over [B, T, F] with projection output Wo
    and optional causal masking."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    causal: bool = False
    # kept for the JAX package's JSON; its layer projects q, k and v
    # whatever the value, and so does the port's
    project_input: bool = True
    max_cache: int = 512
    # "auto" and "pallas" route to the flash kernel wrapper (K1), "stock"
    # forces the plain softmax(QKᵀ)V path
    helper: str = "auto"
    # paged-decode read backend, resolved per call against the tensors'
    # device (see paged_attention.resolve_paged_backend)
    paged_attention: str = "auto"

    STREAMS = True
    DEFAULT_ACTIVATION = "identity"

    def set_n_in(self, n_in: int) -> None:
        if self.n_in == 0:
            self.n_in = int(n_in)
        if self.n_out == 0:
            self.n_out = self.n_in
        if self.n_out % self.n_heads:
            raise ValueError(f"n_out={self.n_out} not divisible by "
                             f"n_heads={self.n_heads}")

    def output_size(self, n_in: int) -> int:
        return self.n_out

    def param_order(self):
        return ["Wq", "Wk", "Wv", "Wo", "b"]

    def init_params(self, gen, dtype=torch.float32, device="cpu"):
        D, O = self.n_in, self.n_out
        return {
            "Wq": self._init_w(gen, (D, O), D, O, dtype, device),
            "Wk": self._init_w(gen, (D, O), D, O, dtype, device),
            "Wv": self._init_w(gen, (D, O), D, O, dtype, device),
            "Wo": self._init_w(gen, (O, O), O, O, dtype, device),
            "b": self._bias(O, dtype, device),
        }

    def _split_heads(self, x):
        B, T, O = x.shape
        H = self.n_heads
        return x.reshape(B, T, H, O // H).permute(0, 2, 1, 3)  # [B,H,T,d]

    def _proj(self, params, x, name):
        """One projection matmul, ``x @ W`` with W ``[n_in, n_out]``."""
        return torch.matmul(x, params[name])

    def _attend(self, q, k, v, mask):
        if self.helper not in ("auto", "pallas", "stock"):
            raise ValueError(f"Unknown helper '{self.helper}'")
        if self.helper == "stock":
            return scaled_dot_attention(q, k, v, causal=self.causal, mask=mask)
        # "auto" and "pallas" both go through K1's wrapper: its plain version
        # for CPU tensors, the kernel for CUDA tensors, which raises on a case
        # the kernel cannot take
        return fa.flash_attention(q, k, v, causal=self.causal, mask=mask)

    def _merge(self, params, o, mask):
        B, H, T, d = o.shape
        o = o.permute(0, 2, 1, 3).reshape(B, T, H * d)
        out = self._proj(params, o, "Wo") + params["b"]
        if mask is not None:
            out = out * mask.to(out.dtype)[:, :, None]
        return self.act()(out)

    def forward(self, params, state, x, *, mask=None):
        if "kpages" in state:
            return self._paged_forward(params, state, x, mask=mask)
        if "kcache" in state:
            return self._streaming_forward(params, state, x, mask=mask)
        q = self._split_heads(self._proj(params, x, "Wq"))
        k = self._split_heads(self._proj(params, x, "Wk"))
        v = self._split_heads(self._proj(params, x, "Wv"))
        return self._merge(params, self._attend(q, k, v, mask), mask), state

    # ------------------------------------------------------ paged decode
    def init_paged_carry(self, pages: int, page_size: int,
                         dtype=torch.float32, kv_dtype=None,
                         device="cpu") -> dict:
        """KV cache as a POOL of fixed-size pages shared by every slot of a
        serving batch; a ``[B, n_pages]`` block table passed per call in
        ``state`` maps each row to its pages. ``kv_dtype="int8"`` stores
        pages int8 with per-token-per-head f32 scales. Non-causal layers
        return no carry."""
        if not self.causal:
            return {}
        H = self.n_heads
        d = self.n_out // H
        if kv_dtype == "int8":
            return {
                "kpages": torch.zeros(pages, H, page_size, d,
                                      dtype=torch.int8, device=device),
                "vpages": torch.zeros(pages, H, page_size, d,
                                      dtype=torch.int8, device=device),
                "kscales": torch.zeros(pages, H, page_size,
                                       dtype=torch.float32, device=device),
                "vscales": torch.zeros(pages, H, page_size,
                                       dtype=torch.float32, device=device),
            }
        if kv_dtype is not None:
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} "
                             "(None or 'int8')")
        return {
            "kpages": torch.zeros(pages, H, page_size, d, dtype=dtype,
                                  device=device),
            "vpages": torch.zeros(pages, H, page_size, d, dtype=dtype,
                                  device=device),
        }

    def init_streaming_carry(self, batch: int, dtype=torch.float32,
                             kv_dtype=None, device="cpu") -> dict:
        """Dense KV cache for incremental decode: ``[batch, H, max_cache,
        d]`` keys and values (int8 with f32 ``kscale``/``vscale`` strips
        under ``kv_dtype="int8"``) and the stream position. Non-causal
        layers return no carry."""
        if not self.causal:
            return {}
        H = self.n_heads
        d = self.n_out // H
        shape = (batch, H, self.max_cache, d)
        pos = torch.zeros((), dtype=torch.int32, device=device)
        if kv_dtype == "int8":
            return {
                "kcache": torch.zeros(shape, dtype=torch.int8, device=device),
                "vcache": torch.zeros(shape, dtype=torch.int8, device=device),
                "kscale": torch.zeros(shape[:3], dtype=torch.float32,
                                      device=device),
                "vscale": torch.zeros(shape[:3], dtype=torch.float32,
                                      device=device),
                "cache_pos": pos,
            }
        if kv_dtype is not None:
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} "
                             "(None or 'int8')")
        return {"kcache": torch.zeros(shape, dtype=dtype, device=device),
                "vcache": torch.zeros(shape, dtype=dtype, device=device),
                "cache_pos": pos}

    def _streaming_forward(self, params, state, x, mask=None):
        """Incremental decode over the dense KV cache: the chunk's keys and
        values land at the stream position (IN PLACE: the returned state
        holds the same cache tensors), and each query row attends over
        every cached column up to its own position, as one masked softmax
        over the whole ``max_cache`` strip (the JAX layer's expressions).
        A chunk that would run past ``max_cache`` raises. ``mask`` is an
        optional ``[B, T]`` validity of the chunk's positions: masked
        columns attend nowhere and their outputs are zeroed, but they still
        take cache columns."""
        B, T, _ = x.shape
        kc, vc, pos = state["kcache"], state["vcache"], state["cache_pos"]
        Tmax = kc.shape[2]
        if pos.dim() != 0:
            raise NotImplementedError(
                "dense streaming with per-row positions is not ported; the "
                "port's server pages its KV (init_paged_carry)")
        p = int(pos)
        if p + T > Tmax:
            raise ValueError(
                f"KV cache overflow: position {p} + {T} new tokens > "
                f"max_cache {Tmax}; raise SelfAttentionLayer.max_cache or "
                "rnn_clear_previous_state() to start a new stream")
        if mask is not None and tuple(mask.shape) != (B, T):
            raise ValueError(
                f"streaming attention mask must be [batch, chunk] = "
                f"({B}, {T}), got {tuple(mask.shape)}")
        q = self._split_heads(self._proj(params, x, "Wq"))
        k = self._split_heads(self._proj(params, x, "Wk"))
        v = self._split_heads(self._proj(params, x, "Wv"))
        quant = "kscale" in state
        if quant:
            ks, vs = state["kscale"], state["vscale"]
            k, ksc = self._quantize_kv(k)
            v, vsc = self._quantize_kv(v)
            ks[:, :, p:p + T] = ksc
            vs[:, :, p:p + T] = vsc
        kc[:, :, p:p + T] = k.to(kc.dtype)
        vc[:, :, p:p + T] = v.to(vc.dtype)
        if quant:
            kd = kc.to(q.dtype) * ks[..., None].to(q.dtype)
            vd = vc.to(q.dtype) * vs[..., None].to(q.dtype)
        else:
            kd, vd = kc, vc
        d = q.shape[-1]
        logits = torch.matmul(q, kd.transpose(-1, -2)) / math.sqrt(d)
        col = torch.arange(Tmax, device=x.device)[None, :]
        row = torch.arange(T, device=x.device)[:, None]
        neg = float(torch.tensor(NEG_INF).to(logits.dtype))  # f16: -inf
        logits = torch.where(col <= p + row, logits, neg)
        if mask is not None:
            # columns of this chunk take the chunk mask, older ones stay
            # valid
            rel = torch.arange(Tmax, device=x.device) - p
            inside = (rel >= 0) & (rel < T)
            chunk_valid = (mask != 0)[:, rel.clamp(0, T - 1)]
            key_valid = torch.where(inside[None], chunk_valid,
                                    torch.ones_like(chunk_valid))
            logits = torch.where(key_valid[:, None, None, :], logits, neg)
        o = torch.matmul(torch.softmax(logits, dim=-1), vd)
        new_state = dict(state)
        new_state["cache_pos"] = pos + T
        return self._merge(params, o, mask), new_state

    @staticmethod
    def _quantize_kv(t):
        """Absmax per-(row, head, token) int8 of a fresh KV chunk
        ``[B, H, T, d]`` -> (int8 values, f32 scales ``[B, H, T]``).
        ``torch.round`` rounds half to even, as ``jnp.round`` does. All-zero
        rows get scale 0 and reconstruct as exact zeros."""
        m = t.abs().amax(dim=-1)
        scale = (m / 127.0).to(torch.float32)
        safe = torch.where(scale > 0, scale,
                           torch.ones_like(scale)).to(t.dtype)
        q = torch.clamp(torch.round(t / safe[..., None]), -127, 127).to(
            torch.int8)
        return q, scale

    def _paged_forward(self, params, state, x, mask=None):
        """Incremental decode over a paged KV pool (see init_paged_carry).

        ``state`` carries, besides the pool itself, ``block_table``
        (``[B, n_pages]`` int32: row b's i-th logical page lives in pool page
        ``block_table[b, i]``) and ``cache_pos`` (``[B]`` per-row stream
        positions). The caller guarantees that a page a row writes this call
        is that row's alone, or the garbage page 0.

        Unlike the JAX layer, the chunk write updates the pool tensors IN
        PLACE (``index_put_`` through advanced indexing): the returned state
        holds the same tensors, and no pool copy is made per call.
        """
        B, T, _ = x.shape
        kp, vp = state["kpages"], state["vpages"]
        bt = state["block_table"]
        pos = state["cache_pos"]
        if pos.dim() != 1:
            raise ValueError("paged attention requires per-row [B] "
                             f"cache_pos, got shape {tuple(pos.shape)}")
        ps = kp.shape[2]
        NP = bt.shape[1]
        if mask is not None and tuple(mask.shape) != (B, T):
            raise ValueError(
                f"streaming attention mask must be [batch, chunk] = "
                f"({B}, {T}), got {tuple(mask.shape)}")
        q = self._split_heads(self._proj(params, x, "Wq"))
        k = self._split_heads(self._proj(params, x, "Wk"))
        v = self._split_heads(self._proj(params, x, "Wv"))
        quant = "kscales" in state
        ksp = vsp = None
        if quant:
            ksp, vsp = state["kscales"], state["vscales"]
            k, ksc = self._quantize_kv(k)
            v, vsc = self._quantize_kv(v)
        # logical position p of row b lands in pool page bt[b, p // ps] at
        # offset p % ps; the advanced indices [B, T] straddle the head slice,
        # so the written value carries the [B, T, H, d] layout
        t_abs = pos.long()[:, None] + torch.arange(T, device=x.device)[None]
        pg = torch.gather(bt.long(), 1, torch.clamp(t_abs // ps, max=NP - 1))
        off = t_abs % ps
        if mask is not None:
            # masked (right-padding) columns write pool page 0, the
            # caller-reserved garbage sink, so padded prefill chunks never
            # dirty real pages
            pg = torch.where(mask != 0, pg, torch.zeros_like(pg))
        kp[pg, :, off] = k.to(kp.dtype).permute(0, 2, 1, 3)
        vp[pg, :, off] = v.to(vp.dtype).permute(0, 2, 1, 3)
        if quant:
            ksp[pg, :, off] = ksc.permute(0, 2, 1)
            vsp[pg, :, off] = vsc.permute(0, 2, 1)
        backend = ppa.resolve_paged_backend(self.paged_attention, q.device)
        o = ppa.paged_attend(backend, q, kp, vp, bt, pos, mask=mask,
                             kscales=ksp, vscales=vsp)
        new_state = dict(state)
        new_state["cache_pos"] = pos + T
        return self._merge(params, o, mask), new_state


@register_serializable
@dataclass
class PositionalEncodingLayer(Layer):
    """Add the fixed sinusoidal position table to a [B, T, F] sequence: sin
    and cos halves concatenated (not interleaved), positions per row when the
    state carries a ``[B]`` ``cache_pos``."""

    max_wavelength: float = 10000.0

    STREAMS = True

    def init_streaming_carry(self, batch: int, dtype=torch.float32,
                             device="cpu") -> dict:
        """Streaming decode: chunk t must get the encoding of its absolute
        position, so the consumed-token count is carried."""
        return {"cache_pos": torch.zeros((), dtype=torch.int32,
                                         device=device)}

    def forward(self, params, state, x, *, mask=None):
        T, F = x.shape[-2], x.shape[-1]
        start = state.get("cache_pos")
        steps = torch.arange(T, dtype=torch.float32, device=x.device)
        if start is not None and start.dim() == 1:
            # per-row stream positions (slot-pooled decode): [B, T, 1]
            pos = start.to(torch.float32)[:, None, None] + steps[None, :, None]
        else:
            pos = steps[:, None] + (0.0 if start is None
                                    else start.to(torch.float32))
        half = (F + 1) // 2
        freq = torch.exp(-math.log(self.max_wavelength)
                         * torch.arange(half, dtype=torch.float32,
                                        device=x.device) / max(half, 1))
        ang = pos * freq                          # [..., T, half]
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[..., :F]
        out = x + pe.to(x.dtype)
        if start is None:
            return out, state
        new_state = dict(state)
        new_state["cache_pos"] = start + T
        return out, new_state
