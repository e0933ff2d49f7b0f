"""Causal linear attention (FAVOR+) for the Performer backbone.

Port of ``emo_disentanger_tpu/ops/linear_attention.py``:

* :func:`favor_features` — positive softmax-kernel features
  phi(x) = exp(w^T x' - ||x'||^2/2) / sqrt(m), x' = x * d^{-1/4};
* :func:`causal_linear_attention_ref` — the O(L^2) masked ground truth;
* :func:`favor_causal_attention` — the forward of the fused op.  On CUDA
  tensors it runs the hand-written kernels of ``csrc/favor_fwd.cu``
  (``favor_kmax``: the key stabilizer; ``favor_fwd``: feature maps and the
  chunked causal prefix sum); on CPU tensors it runs the plain version,
  :func:`_favor_compose` (feature maps + the chunked scan);
* :func:`linear_attention_decode_step` — the O(1)-per-token decode step.

Numerics: all accumulation in float32; the stabilizers (per-position max for
queries, one max per batch*head row for keys) cancel in the normalization.
For L % chunk != 0 the JAX fused kernel also takes the key max over the
zero-padded rows (h = 0 there); the port takes it over the true L, as the
JAX composed path does.  The two differ only at the level of the 1e-6
denominator eps.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

EPS = 1e-6
CHUNK = 128

# the CUDA kernels' own row chunk (sized for shared memory); the result
# differs from other chunk sizes only in float summation order.  Shapes
# whose tiles exceed shared memory are refused by the launch itself.
KERNEL_CHUNK = 64


# ---------------------------------------------------------------------------
# FAVOR+ feature map
# ---------------------------------------------------------------------------

def draw_orthogonal_features(d_head: int, n_dims: int,
                             generator: torch.Generator) -> torch.Tensor:
    """Draw the FAVOR+ random-feature matrix omega [d_head, n_dims] (float32,
    on the generator's device): blocks of orthogonalized Gaussians with
    chi-distributed row norms."""
    dev = generator.device
    n_blocks = -(-n_dims // d_head)
    blocks = []
    for _ in range(n_blocks):
        g = torch.randn(d_head, d_head, generator=generator, device=dev)
        q, r = torch.linalg.qr(g)
        # Haar sign correction (Mezzadri 2006): the raw QR sign convention
        # biases the direction distribution of the features
        q = q * torch.sign(torch.diagonal(r))[None, :]
        blocks.append(q.T)
    w = torch.cat(blocks, dim=0)[:n_dims]                    # [n_dims, d_head]
    norms = torch.randn(n_dims, d_head, generator=generator,
                        device=dev).pow(2).sum(-1, keepdim=True).sqrt()
    return (w * norms).T.contiguous()                        # [d_head, n_dims]


def favor_features(x: torch.Tensor, omega: torch.Tensor, *, is_query: bool,
                   key_stabilizer: Optional[float] = None) -> torch.Tensor:
    """phi(x) for x [..., L, D] -> [..., L, M] (float32).

    Queries subtract their per-position max over features; keys subtract one
    scalar per batch*head (their max over (L, M)), or ``key_stabilizer``
    when given (0 during decode, so the running state keeps one scale)."""
    x = x.float()
    xs = x * x.shape[-1] ** -0.25
    h = xs @ omega.float() - 0.5 * (xs * xs).sum(-1, keepdim=True)
    if is_query:
        h = h - h.amax(-1, keepdim=True)
    elif key_stabilizer is None:
        h = h - h.amax(dim=(-2, -1), keepdim=True)
    else:
        h = h - key_stabilizer
    return torch.exp(h) / math.sqrt(omega.shape[-1])


# ---------------------------------------------------------------------------
# plain implementations
# ---------------------------------------------------------------------------

def causal_linear_attention_ref(phi_q: torch.Tensor, phi_k: torch.Tensor,
                                v: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """O(L^2) masked product; ground truth for the chunked versions.
    Shapes: phi_q/phi_k [..., L, M], v [..., L, Dv]."""
    scores = phi_q @ phi_k.transpose(-1, -2)
    L = scores.shape[-1]
    mask = torch.ones(L, L, dtype=torch.bool, device=scores.device).tril()
    scores = scores.masked_fill(~mask, 0.0)
    return (scores @ v) / (scores.sum(-1, keepdim=True) + eps)


def _scan_impl(phi_q: torch.Tensor, phi_k: torch.Tensor, v: torch.Tensor,
               chunk: int, eps: float) -> torch.Tensor:
    """[BH, L, M] x [BH, L, Dv] -> [BH, L, Dv]; L must divide by chunk.
    The running (S, z) state is carried from chunk to chunk in float32."""
    bh, L, M = phi_q.shape
    Dv = v.shape[-1]
    tri = torch.ones(chunk, chunk, dtype=phi_q.dtype, device=phi_q.device).tril()
    S = torch.zeros(bh, M, Dv, dtype=torch.float32, device=phi_q.device)
    z = torch.zeros(bh, M, dtype=torch.float32, device=phi_q.device)
    outs = []
    for c0 in range(0, L, chunk):
        q = phi_q[:, c0:c0 + chunk]
        k = phi_k[:, c0:c0 + chunk]
        vv = v[:, c0:c0 + chunk]
        intra = (q @ k.transpose(1, 2)) * tri
        num = intra @ vv + q @ S
        den = intra.sum(-1) + (q @ z[:, :, None])[..., 0]
        outs.append(num / (den[..., None] + eps))
        S = S + k.transpose(1, 2) @ vv
        z = z + k.sum(1)
    return torch.cat(outs, dim=1)


def _padded_call(impl, phi_q, phi_k, v, chunk, eps):
    """Flatten leading dims to B*H, pad L to a chunk multiple, call, unpad."""
    *lead, L, M = phi_q.shape
    Dv = v.shape[-1]
    bh = math.prod(lead)
    q2 = phi_q.reshape(bh, L, M)
    k2 = phi_k.reshape(bh, L, M)
    v2 = v.reshape(bh, L, Dv)
    pad = (-L) % chunk
    if pad:
        pad3 = lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad))
        q2, k2, v2 = pad3(q2), pad3(k2), pad3(v2)
    out = impl(q2, k2, v2, chunk, eps)
    return out[:, :L].reshape(*lead, L, Dv)


def _favor_compose(q, k, v, omega, chunk=CHUNK, eps=EPS):
    """Plain version of the fused forward: favor_features + the chunked
    scan, float32 out."""
    phi_q = favor_features(q, omega, is_query=True)
    phi_k = favor_features(k, omega, is_query=False)
    return _padded_call(_scan_impl, phi_q, phi_k, v.float(), chunk, eps)


def _key_max_plain(k2: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Plain version of the key-stabilizer pass: [BH, L, Dh] -> [BH], the
    max over (L, M) of h = ks @ omega - ||ks||^2/2."""
    ks = k2.float() * k2.shape[-1] ** -0.25
    h = ks @ omega.float() - 0.5 * (ks * ks).sum(-1, keepdim=True)
    return h.amax(dim=(1, 2))


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/favor_fwd.cu)
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # (k, omega, partial, BH, L, Dh, M, bf16, stream)
    'favor_kmax': [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (q, k, v, omega, partial, out, BH, L, Dh, Dv, M, bf16, eps, stream)
    'favor_fwd': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                  ctypes.c_float, _P],
}


def _lib():
    return _build.library('favor_fwd', _SIGNATURES)


def _check_cuda(name: str, t: torch.Tensor, dtypes, ndim: int, device) -> None:
    if device.type != 'cuda':
        raise ValueError(f'the CUDA kernels take CUDA tensors (got {device})')
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype not in dtypes:
        raise ValueError(f'{name} has dtype {t.dtype}, expected one of {dtypes}')
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f'{name} must be a contiguous {ndim}-d tensor '
                         f'(got shape {tuple(t.shape)}, '
                         f'contiguous={t.is_contiguous()})')


def _favor_kmax_cuda(k2: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Launch ``favor_kmax``: per-chunk key maxima [BH, ceil(L/64)] f32 (the
    row's stabilizer is their max, taken by ``favor_fwd``)."""
    dev = k2.device
    _check_cuda('k', k2, (torch.float32, torch.bfloat16), 3, dev)
    _check_cuda('omega', omega, (torch.float32,), 2, dev)
    BH, L, Dh = k2.shape
    M = omega.shape[1]
    if omega.shape[0] != Dh or M % 4:
        raise ValueError(f'favor_kmax: omega {tuple(omega.shape)} vs Dh={Dh}; '
                         f'M must be a multiple of 4')
    partial = torch.empty(BH, -(-L // KERNEL_CHUNK), dtype=torch.float32,
                          device=dev)
    lib = _lib()
    err = lib.favor_kmax(k2.data_ptr(), omega.data_ptr(), partial.data_ptr(),
                         BH, L, Dh, M, int(k2.dtype == torch.bfloat16),
                         torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'favor_kmax')
    _build.LAUNCHES['favor_kmax'] += 1
    return partial


def _favor_fwd_cuda(q2, k2, v2, omega, partial, eps=EPS) -> torch.Tensor:
    """Launch ``favor_fwd`` on [BH, L, Dh] q/k, [BH, L, Dv] v and the key
    maxima of :func:`_favor_kmax_cuda`; returns [BH, L, Dv] in q's dtype."""
    dev = q2.device
    _check_cuda('q', q2, (torch.float32, torch.bfloat16), 3, dev)
    _check_cuda('k', k2, (q2.dtype,), 3, dev)
    _check_cuda('v', v2, (q2.dtype,), 3, dev)
    _check_cuda('omega', omega, (torch.float32,), 2, dev)
    _check_cuda('partial', partial, (torch.float32,), 2, dev)
    BH, L, Dh = q2.shape
    Dv = v2.shape[2]
    M = omega.shape[1]
    if (k2.shape != q2.shape or v2.shape[:2] != q2.shape[:2]
            or omega.shape[0] != Dh
            or tuple(partial.shape) != (BH, -(-L // KERNEL_CHUNK))):
        raise ValueError('favor_fwd: mismatched shapes q {} k {} v {} omega {} '
                         'partial {}'.format(*(tuple(t.shape) for t in (
                             q2, k2, v2, omega, partial))))
    if M % 4 or Dv % 4:
        raise ValueError(f'favor_fwd: M={M} and Dv={Dv} must be multiples of 4')
    out = torch.empty(BH, L, Dv, dtype=q2.dtype, device=dev)
    lib = _lib()
    err = lib.favor_fwd(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(),
                        omega.data_ptr(), partial.data_ptr(), out.data_ptr(),
                        BH, L, Dh, Dv, M, int(q2.dtype == torch.bfloat16),
                        eps, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'favor_fwd')
    _build.LAUNCHES['favor_fwd'] += 1
    return out


def favor_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           omega: torch.Tensor, chunk: int = CHUNK,
                           eps: float = EPS) -> torch.Tensor:
    """FAVOR+ causal linear attention, forward.  q/k [..., L, Dh] raw
    projections, v [..., L, Dv], omega [Dh, M].  Returns [..., L, Dv] in
    q's dtype, accumulated in float32.  The same function as
    ``causal_linear_attention_ref(favor_features(q), favor_features(k), v)``.

    CPU tensors run the plain version (chunked by ``chunk``); CUDA tensors
    launch ``favor_kmax`` and ``favor_fwd``, which mask the ragged last chunk
    themselves.  Under bf16 inputs the kernels round the chunk products'
    operands to bf16 with float32 accumulation, as the TPU kernel does."""
    *lead, L, Dh = q.shape
    Dv = v.shape[-1]
    if q.device.type == 'cpu':
        return _favor_compose(q, k, v, omega, chunk, eps).to(q.dtype)
    bh = math.prod(lead)
    q2 = q.reshape(bh, L, Dh).contiguous()
    k2 = k.reshape(bh, L, Dh).contiguous()
    v2 = v.reshape(bh, L, Dv).contiguous()
    om = omega.float().contiguous()
    out = _favor_fwd_cuda(q2, k2, v2, om, _favor_kmax_cuda(k2, om), eps)
    return out.reshape(*lead, L, Dv)


# ---------------------------------------------------------------------------
# decode: O(1) carried state
# ---------------------------------------------------------------------------

def linear_attention_decode_step(
    phi_q: torch.Tensor,          # [..., M]   features of the current query
    phi_k: torch.Tensor,          # [..., M]   features of the current key
    v: torch.Tensor,              # [..., Dv]
    S: torch.Tensor,              # 'dm': [..., Dv, M]; 'md': [..., M, Dv]
    z: torch.Tensor,              # [..., M]   running sum phi(k)
    eps: float = EPS,
    update_mask: Optional[torch.Tensor] = None,   # [...] 0/1 per element
    state_layout: str = 'dm',
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One causal step (current token included): returns (out, S', z') as
    new tensors.  ``update_mask`` zeroes masked elements' contribution to the
    state, freezing it.  ``'dm'`` carries S transposed ([..., Dv, M]), the
    layout the port's decode uses; ``'md'`` is [..., M, Dv]."""
    if update_mask is not None:
        m = update_mask.to(phi_k.dtype)
        while m.dim() < phi_k.dim():
            m = m[..., None]
        phi_k = phi_k * m
    if state_layout == 'dm':
        S = S + v[..., :, None] * phi_k[..., None, :]
        num = (S @ phi_q[..., :, None])[..., 0]
    elif state_layout == 'md':
        S = S + phi_k[..., :, None] * v[..., None, :]
        num = (phi_q[..., None, :] @ S)[..., 0, :]
    else:
        raise ValueError(f'unknown state_layout {state_layout!r}')
    z = z + phi_k
    den = (phi_q * z).sum(-1)
    return num / (den[..., None] + eps), S, z
