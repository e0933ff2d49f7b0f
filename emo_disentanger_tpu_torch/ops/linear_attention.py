"""Causal linear attention (FAVOR+) for the Performer backbone.

Port of ``emo_disentanger_tpu/ops/linear_attention.py``:

* :func:`favor_features` — positive softmax-kernel features
  phi(x) = exp(w^T x' - ||x'||^2/2) / sqrt(m), x' = x * d^{-1/4};
* :func:`causal_linear_attention_ref` — the O(L^2) masked ground truth;
* :func:`favor_causal_attention` — the fused op, differentiable in q, k and
  v (omega's gradient is None: omega is a random-feature input, never a
  parameter).  On CUDA tensors it runs the hand-written kernels of
  ``csrc/favor_fwd.cu`` (``favor_kmax``: the key stabilizer; ``favor_fwd``:
  feature maps and the chunked causal prefix sum) and, backward, those of
  ``csrc/favor_bwd.cu`` (``favor_bwd_a``: the forward replay, dq and the
  (u, w) residual; ``favor_bwd_b``: the reverse suffix scan, dk and dv).
  On CPU tensors it runs the plain versions: :func:`_favor_compose`
  (feature maps + the chunked scan) forward, :func:`_favor_bwd_a_plain` and
  :func:`_favor_bwd_b_plain` backward;
* :func:`favor_causal_attention_heads_last` — the same op on heads-last
  ``[B, L, H * Dh]`` activations (the model's ``EMODIS_HL_ATTN=1``
  configuration): on CUDA the ``*_hl`` entry points of the same kernels
  read each head's columns in place, so no head-split copy is made; on the
  CPU the head-major plain versions run on split copies;
* :func:`causal_linear_attention` — the causal prefix sum over precomputed
  features, so that ``causal_linear_attention(favor_features(q),
  favor_features(k), v)`` composes FAVOR+ attention (the reference's own
  decomposition).  On CUDA tensors it runs ``csrc/linear_attn.cu``
  (``cla_fwd``; backward ``cla_bwd_a``, the forward replay, dphi_q and
  (u, w), then ``cla_bwd_b``, the reverse suffix scan, dphi_k and dv); on
  CPU tensors the chunked scan and the plain passes, which share their
  chunk recurrences (:func:`_bwd_a_scan`, :func:`_bwd_b_scan`) with the
  fused op's plain backward;
* :func:`linear_attention_decode_step` — the O(1)-per-token decode step.

Numerics: all accumulation in float32 (float64 for float64 inputs, which
only the gradient check uses); the stabilizers (per-position max for
queries, one max per batch*head row for keys) cancel in the normalization
and carry no gradient.  For L % chunk != 0 the JAX fused kernel also takes
the key max over the zero-padded rows (h = 0 there); the port takes it over
the true L, as the JAX composed path does.  The two differ only at the level
of the 1e-6 denominator eps.

Backward (derivation in the JAX module, ``:231-243``): with out_i = N_i/D_i
and g = dL/dout, u_i = g_i/D_i and w_i = -(g_i . out_i)/D_i;
dphi_q_i = S_i u_i + w_i z_i from the prefix states (pass A, forward
order), dv_j = phi_k_j R_j and dphi_k_j = R_j v_j + r_j from the suffix
states R_j = sum_{i>=j} phi_q_i u_i^T, r_j = sum_{i>=j} w_i phi_q_i (pass
B, reverse order); dx follows from dphi through the feature map
(:func:`_dphi_to_dx`).  The forward saves q, k, v and the key maxima, not
phi (the JAX residual choice, ``:466-481``).
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


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """float32 accumulation, float64 for float64 inputs."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


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
    """phi(x) for x [..., L, D] -> [..., L, M] (float32; float64 for float64
    x).

    Queries subtract their per-position max over features; keys subtract one
    scalar per batch*head (their max over (L, M)), or ``key_stabilizer``
    when given (0 during decode, so the running state keeps one scale; a
    tensor broadcasts against h [..., L, M])."""
    acc = _acc_dtype(x)
    xs = x.to(acc) * x.shape[-1] ** -0.25
    h = xs @ omega.to(acc) - 0.5 * (xs * xs).sum(-1, keepdim=True)
    if is_query:                     # stabilizers carry no gradient
        h = h - h.amax(-1, keepdim=True).detach()
    elif key_stabilizer is None:
        h = h - h.amax(dim=(-2, -1), keepdim=True).detach()
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
    The running (S, z) state is carried from chunk to chunk in the
    features' type (float32, or float64 for float64 inputs)."""
    bh, L, M = phi_q.shape
    Dv = v.shape[-1]
    tri = torch.ones(chunk, chunk, dtype=phi_q.dtype, device=phi_q.device).tril()
    S = torch.zeros(bh, M, Dv, dtype=phi_q.dtype, device=phi_q.device)
    z = torch.zeros(bh, M, dtype=phi_q.dtype, device=phi_q.device)
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


def _favor_compose(q, k, v, omega, chunk=CHUNK, eps=EPS, kmax=None):
    """Plain version of the fused forward: favor_features + the chunked
    scan, float32 out (float64 for float64 inputs).  Differentiable by
    autograd, so it is also the reference for the backward.  ``kmax``, the
    key maxima [BH] of :func:`_key_max_plain`, spares recomputing them."""
    phi_q = favor_features(q, omega, is_query=True)
    phi_k = favor_features(k, omega, is_query=False, key_stabilizer=(
        None if kmax is None else kmax[:, None, None]))
    return _padded_call(_scan_impl, phi_q, phi_k, v.to(phi_q.dtype), chunk, eps)


def _key_max_plain(k2: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Plain version of the key-stabilizer pass: [BH, L, Dh] -> [BH], the
    max over (L, M) of h = ks @ omega - ||ks||^2/2."""
    acc = _acc_dtype(k2)
    ks = k2.to(acc) * k2.shape[-1] ** -0.25
    h = ks @ omega.to(acc) - 0.5 * (ks * ks).sum(-1, keepdim=True)
    return h.amax(dim=(1, 2))


# ---------------------------------------------------------------------------
# plain backward: the two passes of the fused kernels as chunked scans
# ---------------------------------------------------------------------------

def _dot_dtype_for(x: torch.Tensor) -> Optional[torch.dtype]:
    """The dot-operand type of the fused kernels: bf16 operands (with
    float32 accumulation) under bf16 inputs, exact operands otherwise."""
    return torch.bfloat16 if x.dtype == torch.bfloat16 else None


def _features_padded(x, omega, stab, L_pad):
    """(phi [BH, L_pad, M], xs [BH, L_pad, D]) in the accumulation type, with
    ``stab`` None for queries (per-position max) or the key maxima [BH];
    rows past the true L are zero in both."""
    acc = _acc_dtype(x)
    phi = favor_features(x, omega, is_query=stab is None,
                         key_stabilizer=None if stab is None
                         else stab.to(acc)[:, None, None])
    xs = x.to(acc) * x.shape[-1] ** -0.25
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, L_pad - x.shape[1]))
    return pad(phi), pad(xs)


def _dphi_to_dx(dphi, phi, xs, omega, scale):
    """Chain rule through phi = exp(xs @ omega - ||xs||^2/2), stabilizers
    held constant: dx = scale * ((dphi*phi) @ omega^T - rowsum(dphi*phi) xs),
    in the accumulation type (omega's product stays exact)."""
    t = dphi * phi
    return (t @ omega.t() - t.sum(-1, keepdim=True) * xs) * scale


def _exact(t: torch.Tensor) -> torch.Tensor:
    return t


def _pad_chunks(chunk, *ts):
    """[BH, L, .] tensors in the accumulation type of the first, L
    zero-padded to a chunk multiple, and the [chunk, chunk] lower-triangle
    mask."""
    acc = _acc_dtype(ts[0])
    pad = (-ts[0].shape[1]) % chunk
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=ts[0].device).tril()
    return [torch.nn.functional.pad(t.to(acc), (0, 0, 0, pad)) for t in ts], tri


def _bwd_setup(q, k, v, omega, kmax, chunk, dot_dtype, extra=()):
    acc = _acc_dtype(q)
    L = q.shape[1]
    Lp = L + (-L) % chunk
    om = omega.to(acc)
    phi_q, qs = _features_padded(q, om, None, Lp)
    phi_k, ks = _features_padded(k, om, kmax, Lp)
    c = ((lambda t: t.to(dot_dtype).to(acc)) if dot_dtype is not None
         else _exact)
    (v, *extra), tri = _pad_chunks(chunk, v, *extra)
    return (acc, L, Lp, om, phi_q, qs, phi_k, ks, v, extra, c, tri,
            q.shape[-1] ** -0.25)


def _bwd_a_scan(phi_q, phi_k, v, g, chunk, eps, c, tri):
    """The chunk recurrence of pass A, shared by the fused op's and the
    composed op's plain versions: replay the forward scan over the chunks of
    [BH, Lp, .] tensors (Lp a chunk multiple, the accumulation type)
    carrying the prefix (S, z), and yield, chunk by chunk in order,
    (c0, dphi_q, u = g/den, w = -(g . out)/den).  ``c`` rounds the dot
    operands; ``tri`` is the [chunk, chunk] lower-triangle mask."""
    bh, Lp, M = phi_q.shape
    S = torch.zeros(bh, M, v.shape[-1], dtype=phi_q.dtype, device=phi_q.device)
    z = torch.zeros(bh, M, dtype=phi_q.dtype, device=phi_q.device)
    for c0 in range(0, Lp, chunk):
        pq, pk = phi_q[:, c0:c0 + chunk], phi_k[:, c0:c0 + chunk]
        vv, gg = v[:, c0:c0 + chunk], g[:, c0:c0 + chunk]
        intra = (c(pq) @ c(pk).transpose(1, 2)).masked_fill(~tri, 0.0)
        num = c(intra) @ c(vv) + c(pq) @ c(S)
        den = intra.sum(-1) + (c(pq) @ c(z)[:, :, None])[..., 0] + eps
        out = num / den[..., None]
        u = gg / den[..., None]
        w = -(gg * out).sum(-1) / den
        a = (c(u) @ c(vv).transpose(1, 2) + w[..., None]).masked_fill(~tri, 0.0)
        dphi = (c(a) @ c(pk) + c(u) @ c(S).transpose(1, 2)
                + w[..., None] * z[:, None, :])
        yield c0, dphi, u, w
        S = S + c(pk).transpose(1, 2) @ c(vv)
        z = z + pk.sum(1)


def _bwd_b_scan(phi_q, phi_k, v, u, w, chunk, c, tri):
    """The chunk recurrence of pass B: scan the chunks of [BH, Lp, .]
    tensors in reverse carrying the suffix states R = sum phi_q u^T
    [M, Dv] and r = sum w phi_q [M], and yield (c0, dphi_k, dv) chunk by
    chunk from the last.  u [BH, Lp, Dv] and w [BH, Lp] come from pass A."""
    bh, Lp, M = phi_q.shape
    R = torch.zeros(bh, M, v.shape[-1], dtype=phi_q.dtype, device=phi_q.device)
    r = torch.zeros(bh, M, dtype=phi_q.dtype, device=phi_q.device)
    for c0 in reversed(range(0, Lp, chunk)):
        pq, pk = phi_q[:, c0:c0 + chunk], phi_k[:, c0:c0 + chunk]
        vv, uu, ww = v[:, c0:c0 + chunk], u[:, c0:c0 + chunk], w[:, c0:c0 + chunk]
        a = (c(uu) @ c(vv).transpose(1, 2) + ww[..., None]).masked_fill(~tri, 0.0)
        p = (c(pq) @ c(pk).transpose(1, 2)).masked_fill(~tri, 0.0)
        dphi = (c(a).transpose(1, 2) @ c(pq) + c(vv) @ c(R).transpose(1, 2)
                + r[:, None, :])
        yield c0, dphi, c(p).transpose(1, 2) @ c(uu) + c(pk) @ c(R)
        R = R + c(pq).transpose(1, 2) @ c(uu)
        r = r + (ww[..., None] * pq).sum(1)


def _favor_bwd_a_plain(q, k, v, g, omega, kmax, chunk: int = CHUNK,
                       eps: float = EPS, dot_dtype: Optional[torch.dtype] = None):
    """Plain version of ``favor_bwd_a`` (pass A): replay the forward scan
    over chunks carrying (S, z), and return dq [BH, L, Dh] (accumulation
    type), u = g/den [BH, L, Dv] and w = -(g . out)/den [BH, L], the last
    two stored in ``dot_dtype`` when given (the bf16 residual of the TPU
    kernel) and in the accumulation type otherwise.  q/k [BH, L, Dh],
    v/g [BH, L, Dv], omega [Dh, M], kmax [BH] the key maxima.
    ``dot_dtype`` rounds exactly the operands of the products that the TPU
    kernel rounds (``_fused_bwd_a_kernel``); omega's product stays exact."""
    (acc, L, Lp, om, phi_q, qs, phi_k, _, v, (g,), c, tri,
     scale) = _bwd_setup(q, k, v, omega, kmax, chunk, dot_dtype, (g,))
    res = dot_dtype or acc
    dqs, us, ws = [], [], []
    for c0, dphi, u, w in _bwd_a_scan(phi_q, phi_k, v, g, chunk, eps, c, tri):
        dqs.append(_dphi_to_dx(dphi, phi_q[:, c0:c0 + chunk],
                               qs[:, c0:c0 + chunk], om, scale))
        us.append(u.to(res))
        ws.append(w.to(res))
    cat = lambda ts: torch.cat(ts, dim=1)[:, :L]
    return cat(dqs), cat(us), cat(ws)


def _favor_bwd_b_plain(q, k, v, u, w, omega, kmax, chunk: int = CHUNK,
                       dot_dtype: Optional[torch.dtype] = None):
    """Plain version of ``favor_bwd_b`` (pass B): scan the chunks in reverse
    carrying the suffix states R = sum phi_q u^T [M, Dv] and
    r = sum w phi_q [M]; return dk [BH, L, Dh] and dv [BH, L, Dv] in the
    accumulation type.  u [BH, L, Dv] and w [BH, L] come from pass A;
    ``dot_dtype`` rounds the operands ``_fused_bwd_b_kernel`` rounds."""
    (acc, L, Lp, om, phi_q, _, phi_k, ks, v, (u, w), c, tri,
     scale) = _bwd_setup(q, k, v, omega, kmax, chunk, dot_dtype,
                         (u, w[..., None]))
    dks, dvs = [], []
    for c0, dphi, dv in _bwd_b_scan(phi_q, phi_k, v, u, w[..., 0], chunk, c, tri):
        dvs.append(dv)
        dks.append(_dphi_to_dx(dphi, phi_k[:, c0:c0 + chunk],
                               ks[:, c0:c0 + chunk], om, scale))
    cat = lambda ts: torch.cat(ts[::-1], dim=1)[:, :L]
    return cat(dks), cat(dvs)


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
    # heads-last: (k, omega, partial, B, H, L, Dh, M, bf16, stream)
    'favor_kmax_hl': [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # heads-last: (q, k, v, omega, partial, out, B, H, L, Dh, M, bf16, eps,
    #  stream)
    'favor_fwd_hl': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     ctypes.c_float, _P],
}


def _lib():
    return _build.library('favor_fwd', _SIGNATURES)


def _require_cuda(device) -> None:
    if device.type != 'cuda':
        raise ValueError(f'the CUDA kernels take CUDA tensors (got {device})')


def _check_cuda(name: str, t: torch.Tensor, dtypes, ndim: int, device) -> None:
    _require_cuda(device)
    _check_tensor(name, t, dtypes, ndim, device)


def _check_tensor(name: str, t: torch.Tensor, dtypes, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype not in dtypes:
        raise ValueError(f'{name} has dtype {t.dtype}, expected one of {dtypes}')
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f'{name} must be a contiguous {ndim}-d tensor '
                         f'(got shape {tuple(t.shape)}, '
                         f'contiguous={t.is_contiguous()})')


def _favor_tile(dtype) -> int:
    """The multiple the FAVOR+ key max, forward and both backward passes
    take for Dh, Dv and M: 16 under bf16, whose products run on the tensor
    cores in 16-wide steps (mma m16n8k16), 4 in f32 (4 x 4 register
    tiles)."""
    return 16 if dtype == torch.bfloat16 else 4


def _width_rule(tile) -> str:
    return f'multiples of {tile}' + (' under bf16' if tile == 16 else '')


_BF16_ALIGN = {torch.bfloat16: 16}


def _check_aligned(name, tensors, align=_BF16_ALIGN) -> None:
    """Raise unless each tensor of a dtype in ``align`` starts on a boundary
    of that many bytes: under bf16 the FAVOR+ key max, forward and both
    backward passes load their rows 16 bytes at a time, and so do the
    composed op's f32 backward passes (``{torch.float32: 16}``); its
    forward loads four values at a time in each input's own type
    (``_CLA_FWD_ALIGN``)."""
    for n, t in tensors:
        nbytes = align.get(t.dtype)
        if nbytes and t.data_ptr() % nbytes:
            kind = 'bf16' if t.dtype == torch.bfloat16 else 'f32'
            raise ValueError(f'{name}: {kind} {n} must start on a {nbytes}-byte '
                             f'boundary (got an offset of {t.data_ptr() % nbytes})')


def _check_kmax_inputs(k2, omega):
    """Raise unless ``favor_kmax`` takes these, on k's device; (BH, L, Dh,
    M).  Under bf16 the kernel runs on the tensor cores with 16-byte loads,
    as the forward does: Dh and M multiples of 16, k 16-byte aligned; in
    f32, M a multiple of 4."""
    dev = k2.device
    _check_tensor('k', k2, (torch.float32, torch.bfloat16), 3, dev)
    _check_tensor('omega', omega, (torch.float32,), 2, dev)
    BH, L, Dh = k2.shape
    M = omega.shape[1]
    if omega.shape[0] != Dh:
        raise ValueError(f'favor_kmax: omega {tuple(omega.shape)} vs Dh={Dh}')
    if _favor_tile(k2.dtype) == 16 and (Dh % 16 or M % 16):
        raise ValueError(f'favor_kmax: Dh={Dh} and M={M} must be '
                         f'{_width_rule(16)}')
    if M % 4:
        raise ValueError(f'favor_kmax: M={M} must be a multiple of 4')
    _check_aligned('favor_kmax', (('k', k2),))
    return BH, L, Dh, M


def _favor_kmax_cuda(k2: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Launch ``favor_kmax``: per-chunk key maxima [BH, ceil(L/64)] f32 (the
    row's stabilizer is their max, taken by ``favor_fwd``)."""
    dev = k2.device
    _require_cuda(dev)
    BH, L, Dh, M = _check_kmax_inputs(k2, omega)
    partial = torch.empty(BH, -(-L // KERNEL_CHUNK), dtype=torch.float32,
                          device=dev)
    lib = _lib()
    err = lib.favor_kmax(k2.data_ptr(), omega.data_ptr(), partial.data_ptr(),
                         BH, L, Dh, M, int(k2.dtype == torch.bfloat16),
                         torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'favor_kmax')
    _build.LAUNCHES['favor_kmax'] += 1
    return partial


def _check_favor_shapes(name, q2, k2, v2, omega, partial, tile=4):
    BH, L, Dh = q2.shape
    Dv, M = v2.shape[2], omega.shape[1]
    if (k2.shape != q2.shape or v2.shape[:2] != q2.shape[:2]
            or omega.shape[0] != Dh or partial.shape[0] != BH):
        raise ValueError(f'{name}: mismatched shapes q {tuple(q2.shape)} k '
                         f'{tuple(k2.shape)} v {tuple(v2.shape)} omega '
                         f'{tuple(omega.shape)} partial {tuple(partial.shape)}')
    if M % tile or Dv % tile or Dh % tile:
        raise ValueError(f'{name}: Dh={Dh}, Dv={Dv} and M={M} must be '
                         f'{_width_rule(tile)}')
    return BH, L, Dh, Dv, M


def _check_fwd_inputs(q2, k2, v2, omega, partial):
    """Raise unless ``favor_fwd`` takes these, on q's device; (BH, L, Dh,
    Dv, M)."""
    dev = q2.device
    _check_tensor('q', q2, (torch.float32, torch.bfloat16), 3, dev)
    for name, t in (('k', k2), ('v', v2)):
        _check_tensor(name, t, (q2.dtype,), 3, dev)
    _check_tensor('omega', omega, (torch.float32,), 2, dev)
    _check_tensor('partial', partial, (torch.float32,), 2, dev)
    BH, L, Dh, Dv, M = dims = _check_favor_shapes('favor_fwd', q2, k2, v2, omega,
                                                  partial, _favor_tile(q2.dtype))
    if partial.shape[1] != -(-L // KERNEL_CHUNK):
        raise ValueError(f'favor_fwd: partial {tuple(partial.shape)} for L={L}')
    _check_aligned('favor_fwd', (('q', q2), ('k', k2), ('v', v2)))
    return dims


def _favor_fwd_cuda(q2, k2, v2, omega, partial, eps=EPS) -> torch.Tensor:
    """Launch ``favor_fwd`` on [BH, L, Dh] q/k, [BH, L, Dv] v and the key
    maxima of :func:`_favor_kmax_cuda`; returns [BH, L, Dv] in q's dtype."""
    dev = q2.device
    _require_cuda(dev)
    BH, L, Dh, Dv, M = _check_fwd_inputs(q2, k2, v2, omega, partial)
    out = torch.empty(BH, L, Dv, dtype=q2.dtype, device=dev)
    lib = _lib()
    err = lib.favor_fwd(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(),
                        omega.data_ptr(), partial.data_ptr(), out.data_ptr(),
                        BH, L, Dh, Dv, M, int(q2.dtype == torch.bfloat16),
                        eps, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'favor_fwd')
    _build.LAUNCHES['favor_fwd'] += 1
    return out


_BWD_SIGNATURES = {
    # (q, k, v, g, omega, partial, dq, u, w, BH, L, Dh, Dv, M, n_partial,
    #  bf16, eps, stream)
    'favor_bwd_a': [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                    _I, _I, ctypes.c_float, _P],
    # (q, k, v, u, w, omega, partial, dk, dv, BH, L, Dh, Dv, M, n_partial,
    #  bf16, stream)
    'favor_bwd_b': [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                    _I, _I, _P],
    # heads-last: (q, k, v, g, omega, partial, dq, u, w, B, H, L, Dh, M,
    #  n_partial, bf16, eps, stream)
    'favor_bwd_a_hl': [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, ctypes.c_float, _P],
    # heads-last: (q, k, v, u, w, omega, partial, dk, dv, B, H, L, Dh, M,
    #  n_partial, bf16, stream)
    'favor_bwd_b_hl': [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _P],
}


def _bwd_lib():
    return _build.library('favor_bwd', _BWD_SIGNATURES)


def _check_bwd_a_inputs(q2, k2, v2, g2, omega, partial):
    """Raise unless pass A takes these, on q's device; (BH, L, Dh, Dv, M)."""
    dev = q2.device
    _check_tensor('q', q2, (torch.float32, torch.bfloat16), 3, dev)
    for name, t in (('k', k2), ('v', v2), ('g', g2)):
        _check_tensor(name, t, (q2.dtype,), 3, dev)
    _check_tensor('omega', omega, (torch.float32,), 2, dev)
    _check_tensor('partial', partial, (torch.float32,), 2, dev)
    dims = _check_favor_shapes('favor_bwd_a', q2, k2, v2, omega, partial,
                               _favor_tile(q2.dtype))
    if g2.shape != v2.shape:
        raise ValueError(f'favor_bwd_a: g {tuple(g2.shape)} vs v '
                         f'{tuple(v2.shape)}')
    _check_aligned('favor_bwd_a', (('q', q2), ('k', k2), ('v', v2), ('g', g2)))
    return dims


def _favor_bwd_a_cuda(q2, k2, v2, g2, omega, partial, eps=EPS):
    """Launch ``favor_bwd_a`` (pass A) on [BH, L, Dh] q/k, [BH, L, Dv] v and
    g (one dtype), omega [Dh, M] f32 and the key maxima of
    :func:`_favor_kmax_cuda` [BH, n] f32.  Returns dq [BH, L, Dh] in q's
    dtype, u [BH, L, Dv] and w [BH, L] in q's dtype (bf16 under bf16)."""
    dev = q2.device
    _require_cuda(dev)
    BH, L, Dh, Dv, M = _check_bwd_a_inputs(q2, k2, v2, g2, omega, partial)
    dq = torch.empty_like(q2)
    u = torch.empty_like(v2)
    w = torch.empty(BH, L, dtype=q2.dtype, device=dev)
    lib = _bwd_lib()
    err = lib.favor_bwd_a(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(),
                          g2.data_ptr(), omega.data_ptr(), partial.data_ptr(),
                          dq.data_ptr(), u.data_ptr(), w.data_ptr(),
                          BH, L, Dh, Dv, M, partial.shape[1],
                          int(q2.dtype == torch.bfloat16), eps,
                          torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'favor_bwd_a')
    _build.LAUNCHES['favor_bwd_a'] += 1
    return dq, u, w


def _check_bwd_b_inputs(q2, k2, v2, u, w, omega, partial):
    """Raise unless pass B takes these, on q's device; (BH, L, Dh, Dv, M)."""
    dev = q2.device
    _check_tensor('q', q2, (torch.float32, torch.bfloat16), 3, dev)
    for name, t in (('k', k2), ('v', v2), ('u', u)):
        _check_tensor(name, t, (q2.dtype,), 3, dev)
    _check_tensor('w', w, (q2.dtype,), 2, dev)
    _check_tensor('omega', omega, (torch.float32,), 2, dev)
    _check_tensor('partial', partial, (torch.float32,), 2, dev)
    BH, L, Dh, Dv, M = dims = _check_favor_shapes('favor_bwd_b', q2, k2, v2,
                                                  omega, partial,
                                                  _favor_tile(q2.dtype))
    if u.shape != v2.shape or tuple(w.shape) != (BH, L):
        raise ValueError(f'favor_bwd_b: u {tuple(u.shape)} w {tuple(w.shape)} '
                         f'vs v {tuple(v2.shape)}')
    _check_aligned('favor_bwd_b', (('q', q2), ('k', k2), ('v', v2), ('u', u)))
    return dims


def _favor_bwd_b_cuda(q2, k2, v2, u, w, omega, partial):
    """Launch ``favor_bwd_b`` (pass B) on the inputs of pass A and its
    (u, w); returns dk [BH, L, Dh] and dv [BH, L, Dv] in q's dtype."""
    dev = q2.device
    _require_cuda(dev)
    BH, L, Dh, Dv, M = _check_bwd_b_inputs(q2, k2, v2, u, w, omega, partial)
    dk = torch.empty_like(k2)
    dv = torch.empty_like(v2)
    lib = _bwd_lib()
    err = lib.favor_bwd_b(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(),
                          u.data_ptr(), w.data_ptr(), omega.data_ptr(),
                          partial.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                          BH, L, Dh, Dv, M, partial.shape[1],
                          int(q2.dtype == torch.bfloat16),
                          torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'favor_bwd_b')
    _build.LAUNCHES['favor_bwd_b'] += 1
    return dk, dv


class _FavorAttention(torch.autograd.Function):
    """[BH, L, Dh] q/k, [BH, L, Dv] v, omega [Dh, M] -> [BH, L, Dv] in q's
    dtype.  Saves q, k, v and the key maxima (the forward's own, reused by
    the backward); omega gets no gradient."""

    @staticmethod
    def forward(ctx, q2, k2, v2, omega, chunk, eps):
        if q2.device.type == 'cpu':
            kmax = _key_max_plain(k2, omega)
            out = _favor_compose(q2, k2, v2, omega, chunk, eps,
                                 kmax).to(q2.dtype)
        else:
            kmax = _favor_kmax_cuda(k2, omega)
            out = _favor_fwd_cuda(q2, k2, v2, omega, kmax, eps)
        ctx.save_for_backward(q2, k2, v2, omega, kmax)
        ctx.chunk, ctx.eps = chunk, eps
        return out

    @staticmethod
    def backward(ctx, g):
        q2, k2, v2, omega, kmax = ctx.saved_tensors
        g2 = g.to(q2.dtype).contiguous()
        if q2.device.type == 'cpu':
            dt = _dot_dtype_for(q2)
            dq, u, w = _favor_bwd_a_plain(q2, k2, v2, g2, omega, kmax,
                                          ctx.chunk, ctx.eps, dt)
            dk, dv = _favor_bwd_b_plain(q2, k2, v2, u, w, omega, kmax,
                                        ctx.chunk, dt)
        else:
            dq, u, w = _favor_bwd_a_cuda(q2, k2, v2, g2, omega, kmax, ctx.eps)
            dk, dv = _favor_bwd_b_cuda(q2, k2, v2, u, w, omega, kmax)
        return (dq.to(q2.dtype), dk.to(k2.dtype), dv.to(v2.dtype),
                None, None, None)


def favor_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           omega: torch.Tensor, chunk: int = CHUNK,
                           eps: float = EPS) -> torch.Tensor:
    """FAVOR+ causal linear attention.  q/k [..., L, Dh] raw projections,
    v [..., L, Dv], omega [Dh, M].  Returns [..., L, Dv] in q's dtype,
    accumulated in float32.  The same function as
    ``causal_linear_attention_ref(favor_features(q), favor_features(k), v)``,
    differentiable in q, k and v.

    CPU tensors run the plain versions (chunked by ``chunk``); CUDA tensors
    launch ``favor_kmax`` and ``favor_fwd`` forward and ``favor_bwd_a`` and
    ``favor_bwd_b`` backward, which mask the ragged last chunk themselves.
    Under bf16 inputs the kernels round the chunk products' operands to bf16
    with float32 accumulation, as the TPU kernels do, and keep the (u, w)
    residual in bf16; there they run on the tensor cores and take Dh, Dv
    and M multiples of 16 (4 in f32), raising otherwise."""
    *lead, L, Dh = q.shape
    Dv = v.shape[-1]
    bh = math.prod(lead)
    q2 = q.reshape(bh, L, Dh).contiguous()
    k2 = k.reshape(bh, L, Dh).contiguous()
    v2 = v.reshape(bh, L, Dv).contiguous()
    om = omega.to(_acc_dtype(q)).contiguous()
    out = _FavorAttention.apply(q2, k2, v2, om, chunk, eps)
    return out.reshape(*lead, L, Dv)


# ---------------------------------------------------------------------------
# heads-last: [B, L, H * Dh] activations, the head split inside the kernels
# ---------------------------------------------------------------------------

# the JAX heads-last kernels keep each head's key max in one 128-lane tile
# and refuse more features (``ops/linear_attention.py:1295-1299`` there); the
# CUDA path refuses the same configurations
HL_MAX_FEATURES = 128


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, L, H * Dh] -> contiguous [B * H, L, Dh], row b * H + h."""
    B, L, D = x.shape
    return x.reshape(B, L, n_head, D // n_head).transpose(1, 2).reshape(
        B * n_head, L, D // n_head)


def _merge_heads(x: torch.Tensor, batch: int) -> torch.Tensor:
    """[B * H, L, Dh] -> [B, L, H * Dh], the inverse of :func:`_split_heads`."""
    BH, L, Dh = x.shape
    return x.reshape(batch, BH // batch, L, Dh).transpose(1, 2).reshape(
        batch, L, BH // batch * Dh)


def _hl_compose(q, k, v, omega, n_head, chunk=CHUNK, eps=EPS, kmax=None):
    """Plain version of the heads-last forward: head split, the head-major
    :func:`_favor_compose`, merge back; in q's dtype.  ``kmax`` [B * H] as
    :func:`_key_max_plain` gives it for the split keys."""
    sp = lambda t: _split_heads(t, n_head)
    out = _favor_compose(sp(q), sp(k), sp(v), omega, chunk, eps, kmax)
    return _merge_heads(out, q.shape[0]).to(q.dtype)


def _hl_shapes(name, q, omega, n_head, tile=4):
    """(B, L, Dh, M) of heads-last q [B, L, H * Dh] and omega [Dh, M]; Dh
    and M multiples of ``tile``."""
    B, L, D = q.shape
    Dh, M = D // n_head, omega.shape[1]
    if M > HL_MAX_FEATURES:
        raise NotImplementedError(
            f'{name}: the heads-last kernels take favor_dims <= '
            f'{HL_MAX_FEATURES} (got {M}); use favor_causal_attention')
    if D % n_head or omega.shape[0] != Dh:
        raise ValueError(f'{name}: width {D} with {n_head} heads vs omega '
                         f'{tuple(omega.shape)}')
    if M % tile or Dh % tile:
        raise ValueError(f'{name}: Dh={Dh} and M={M} must be '
                         f'{_width_rule(tile)}')
    return B, L, Dh, M


def _check_kmax_hl_inputs(k, omega, n_head):
    """Raise unless ``favor_kmax_hl`` takes these, on k's device; (B, L, Dh,
    M).  The shape check (M <= 128 first) comes first, since the op's first
    launch is this one; the widths and alignment as
    :func:`_check_kmax_inputs`, but Dh a multiple of 4 in f32 too."""
    B, L, Dh, M = _hl_shapes('favor_kmax_hl', k, omega, n_head,
                             _favor_tile(k.dtype))
    _check_tensor('k', k, (torch.float32, torch.bfloat16), 3, k.device)
    _check_tensor('omega', omega, (torch.float32,), 2, k.device)
    _check_aligned('favor_kmax_hl', (('k', k),))
    return B, L, Dh, M


def _favor_kmax_hl_cuda(k, omega, n_head):
    """Launch ``favor_kmax_hl`` on heads-last k [B, L, H * Dh]: per-chunk key
    maxima [B * H, ceil(L/64)] f32, row b * H + h."""
    B, L, Dh, M = _check_kmax_hl_inputs(k, omega, n_head)
    dev = k.device
    _require_cuda(dev)
    partial = torch.empty(B * n_head, -(-L // KERNEL_CHUNK), dtype=torch.float32,
                          device=dev)
    lib = _lib()
    err = lib.favor_kmax_hl(k.data_ptr(), omega.data_ptr(), partial.data_ptr(),
                            B, n_head, L, Dh, M, int(k.dtype == torch.bfloat16),
                            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'favor_kmax_hl')
    _build.LAUNCHES['favor_kmax_hl'] += 1
    return partial


def _check_hl_inputs(name, q, others, omega, partial, n_head, tile=4):
    """Raise unless a heads-last kernel takes q, the (name, tensor) pairs
    ``others`` of q's shape, omega and partial, on q's device; (B, L, Dh, M)."""
    dev = q.device
    _check_tensor('q', q, (torch.float32, torch.bfloat16), 3, dev)
    for n, t in others:
        _check_tensor(n, t, (q.dtype,), 3, dev)
        if t.shape != q.shape:
            raise ValueError(f'{name}: {n} {tuple(t.shape)} vs q {tuple(q.shape)}')
    _check_tensor('omega', omega, (torch.float32,), 2, dev)
    _check_tensor('partial', partial, (torch.float32,), 2, dev)
    B, L, Dh, M = _hl_shapes(name, q, omega, n_head, tile)
    if tuple(partial.shape) != (B * n_head, -(-L // KERNEL_CHUNK)):
        raise ValueError(f'{name}: partial {tuple(partial.shape)} for B={B}, '
                         f'H={n_head}, L={L}')
    return B, L, Dh, M


def _check_fwd_hl_inputs(q, k, v, omega, partial, n_head):
    """Raise unless ``favor_fwd_hl`` takes these, on q's device;
    (B, L, Dh, M)."""
    others = (('k', k), ('v', v))
    dims = _check_hl_inputs('favor_fwd_hl', q, others, omega, partial, n_head,
                            _favor_tile(q.dtype))
    _check_aligned('favor_fwd_hl', (('q', q),) + others)
    return dims


def _favor_fwd_hl_cuda(q, k, v, omega, partial, n_head, eps=EPS):
    """Launch ``favor_fwd_hl`` on heads-last q, k, v [B, L, H * Dh] and the
    key maxima of :func:`_favor_kmax_hl_cuda`; returns [B, L, H * Dh] in
    q's dtype."""
    _require_cuda(q.device)
    B, L, Dh, M = _check_fwd_hl_inputs(q, k, v, omega, partial, n_head)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.favor_fwd_hl(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           omega.data_ptr(), partial.data_ptr(), out.data_ptr(),
                           B, n_head, L, Dh, M, int(q.dtype == torch.bfloat16),
                           eps, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, 'favor_fwd_hl')
    _build.LAUNCHES['favor_fwd_hl'] += 1
    return out


def _check_bwd_a_hl_inputs(q, k, v, g, omega, partial, n_head):
    """Raise unless heads-last pass A takes these, on q's device;
    (B, L, Dh, M)."""
    others = (('k', k), ('v', v), ('g', g))
    dims = _check_hl_inputs('favor_bwd_a_hl', q, others, omega, partial, n_head,
                            _favor_tile(q.dtype))
    _check_aligned('favor_bwd_a_hl', (('q', q),) + others)
    return dims


def _favor_bwd_a_hl_cuda(q, k, v, g, omega, partial, n_head, eps=EPS):
    """Launch ``favor_bwd_a_hl`` (pass A) on heads-last q, k, v, g
    [B, L, H * Dh].  Returns dq and u [B, L, H * Dh] and w [B * H, L], all
    in q's dtype (bf16 under bf16)."""
    _require_cuda(q.device)
    B, L, Dh, M = _check_bwd_a_hl_inputs(q, k, v, g, omega, partial, n_head)
    dq = torch.empty_like(q)
    u = torch.empty_like(v)
    w = torch.empty(B * n_head, L, dtype=q.dtype, device=q.device)
    lib = _bwd_lib()
    err = lib.favor_bwd_a_hl(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             g.data_ptr(), omega.data_ptr(), partial.data_ptr(),
                             dq.data_ptr(), u.data_ptr(), w.data_ptr(),
                             B, n_head, L, Dh, M, partial.shape[1],
                             int(q.dtype == torch.bfloat16), eps,
                             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, 'favor_bwd_a_hl')
    _build.LAUNCHES['favor_bwd_a_hl'] += 1
    return dq, u, w


def _check_bwd_b_hl_inputs(q, k, v, u, w, omega, partial, n_head):
    """Raise unless heads-last pass B takes these, on q's device;
    (B, L, Dh, M)."""
    others = (('k', k), ('v', v), ('u', u))
    B, L, Dh, M = dims = _check_hl_inputs('favor_bwd_b_hl', q, others, omega,
                                          partial, n_head, _favor_tile(q.dtype))
    _check_tensor('w', w, (q.dtype,), 2, q.device)
    if tuple(w.shape) != (B * n_head, L):
        raise ValueError(f'favor_bwd_b_hl: w {tuple(w.shape)} for B={B}, '
                         f'H={n_head}, L={L}')
    _check_aligned('favor_bwd_b_hl', (('q', q),) + others)
    return dims


def _favor_bwd_b_hl_cuda(q, k, v, u, w, omega, partial, n_head):
    """Launch ``favor_bwd_b_hl`` (pass B) on the inputs of pass A and its
    (u, w); returns dk and dv [B, L, H * Dh] in q's dtype."""
    _require_cuda(q.device)
    B, L, Dh, M = _check_bwd_b_hl_inputs(q, k, v, u, w, omega, partial, n_head)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _bwd_lib()
    err = lib.favor_bwd_b_hl(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             u.data_ptr(), w.data_ptr(), omega.data_ptr(),
                             partial.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                             B, n_head, L, Dh, M, partial.shape[1],
                             int(q.dtype == torch.bfloat16),
                             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, 'favor_bwd_b_hl')
    _build.LAUNCHES['favor_bwd_b_hl'] += 1
    return dk, dv


class _FavorAttentionHL(torch.autograd.Function):
    """Heads-last q, k, v [B, L, H * Dh], omega [Dh, M] -> [B, L, H * Dh] in
    q's dtype.  Saves q, k, v and the forward's key maxima; omega gets no
    gradient.  The CPU runs the head-major plain versions on split copies,
    so it gives exactly what :class:`_FavorAttention` gives on them."""

    @staticmethod
    def forward(ctx, q, k, v, omega, n_head, chunk, eps):
        if q.device.type == 'cpu':
            kmax = _key_max_plain(_split_heads(k, n_head), omega)
            out = _hl_compose(q, k, v, omega, n_head, chunk, eps, kmax)
        else:
            kmax = _favor_kmax_hl_cuda(k, omega, n_head)
            out = _favor_fwd_hl_cuda(q, k, v, omega, kmax, n_head, eps)
        ctx.save_for_backward(q, k, v, omega, kmax)
        ctx.n_head, ctx.chunk, ctx.eps = n_head, chunk, eps
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, omega, kmax = ctx.saved_tensors
        H = ctx.n_head
        g = g.to(q.dtype).contiguous()
        if q.device.type == 'cpu':
            sp = lambda t: _split_heads(t, H)
            dt = _dot_dtype_for(q)
            dq, u, w = _favor_bwd_a_plain(sp(q), sp(k), sp(v), sp(g), omega,
                                          kmax, ctx.chunk, ctx.eps, dt)
            dk, dv = _favor_bwd_b_plain(sp(q), sp(k), sp(v), u, w, omega, kmax,
                                        ctx.chunk, dt)
            dq, dk, dv = (_merge_heads(t, q.shape[0]) for t in (dq, dk, dv))
        else:
            dq, u, w = _favor_bwd_a_hl_cuda(q, k, v, g, omega, kmax, H, ctx.eps)
            dk, dv = _favor_bwd_b_hl_cuda(q, k, v, u, w, omega, kmax, H)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def favor_causal_attention_heads_last(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, omega: torch.Tensor,
                                      n_head: int, chunk: int = CHUNK,
                                      eps: float = EPS) -> torch.Tensor:
    """FAVOR+ causal linear attention on heads-last activations: q, k, v
    [B, L, H * Dh] raw projections, omega [Dh, M].  Returns [B, L, H * Dh]
    in q's dtype: :func:`favor_causal_attention` on the head-split tensors,
    merged back, differentiable in q, k and v.

    CUDA tensors launch ``favor_kmax_hl`` and ``favor_fwd_hl`` forward and
    ``favor_bwd_a_hl`` and ``favor_bwd_b_hl`` backward, which read each
    head's columns in place; they take M <= 128, as JAX's heads-last kernels
    do, and raise NotImplementedError beyond.  CPU tensors run the
    head-major plain versions on split copies."""
    om = omega.to(_acc_dtype(q)).contiguous()
    return _FavorAttentionHL.apply(q.contiguous(), k.contiguous(),
                                   v.contiguous(), om, n_head, chunk, eps)


# ---------------------------------------------------------------------------
# causal linear attention over precomputed features (csrc/linear_attn.cu)
# ---------------------------------------------------------------------------

def _cla_fwd_plain(phi_q, phi_k, v, chunk: int = CHUNK, eps: float = EPS):
    """Plain version of ``cla_fwd``: [BH, L, M] features and [BH, L, Dv] v of
    any float type, widened to the accumulation type (float32; float64 for
    float64 features) as the kernel widens them on load, through the
    chunked scan.  Returns [BH, L, Dv] in the accumulation type."""
    acc = _acc_dtype(phi_q)
    return _padded_call(_scan_impl, phi_q.to(acc), phi_k.to(acc), v.to(acc),
                        chunk, eps)


def _cla_bwd_a_plain(phi_q, phi_k, v, g, chunk: int = CHUNK, eps: float = EPS):
    """Plain version of ``cla_bwd_a`` (pass A) on [BH, L, M] features and
    [BH, L, Dv] v and g: dphi_q [BH, L, M], u = g/den [BH, L, Dv] and
    w = -(g . out)/den [BH, L], all in the accumulation type."""
    L = phi_q.shape[1]
    (q, k, v, g), tri = _pad_chunks(chunk, phi_q, phi_k, v, g)
    outs = list(zip(*((dphi, u, w) for _, dphi, u, w in
                      _bwd_a_scan(q, k, v, g, chunk, eps, _exact, tri))))
    return tuple(torch.cat(ts, dim=1)[:, :L] for ts in outs)


def _cla_bwd_b_plain(phi_q, phi_k, v, u, w, chunk: int = CHUNK):
    """Plain version of ``cla_bwd_b`` (pass B) on the inputs of pass A and
    its u [BH, L, Dv] and w [BH, L]: dphi_k [BH, L, M] and dv [BH, L, Dv]
    in the accumulation type."""
    L = phi_q.shape[1]
    (q, k, v, u, w), tri = _pad_chunks(chunk, phi_q, phi_k, v, u, w[..., None])
    outs = list(zip(*((dphi, dv) for _, dphi, dv in
                      _bwd_b_scan(q, k, v, u, w[..., 0], chunk, _exact, tri))))
    return tuple(torch.cat(ts[::-1], dim=1)[:, :L] for ts in outs)


_CLA_SIGNATURES = {
    # (phi_q, phi_k, v, out, BH, L, M, Dv, q_bf16, k_bf16, v_bf16, eps, stream)
    'cla_fwd': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # (phi_q, phi_k, v, g, dphi_q, u, w, BH, L, M, Dv, eps, stream)
    'cla_bwd_a': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
    # (phi_q, phi_k, v, u, w, dphi_k, dv, BH, L, M, Dv, stream)
    'cla_bwd_b': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _cla_lib():
    return _build.library('linear_attn', _CLA_SIGNATURES)


def _check_cla_inputs(name, q2, k2, v2, dtypes):
    """(BH, L, M, Dv) of [BH, L, M] features and [BH, L, Dv] v, contiguous
    CUDA tensors, each of a dtype from ``dtypes``; raises otherwise."""
    dev = q2.device
    _check_cuda('phi_q', q2, dtypes, 3, dev)
    _check_cuda('phi_k', k2, dtypes, 3, dev)
    _check_cuda('v', v2, dtypes, 3, dev)
    BH, L, M = q2.shape
    Dv = v2.shape[2]
    if k2.shape != q2.shape or v2.shape[:2] != q2.shape[:2]:
        raise ValueError(f'{name}: mismatched shapes phi_q {tuple(q2.shape)} '
                         f'phi_k {tuple(k2.shape)} v {tuple(v2.shape)}')
    if M % 4 or Dv % 4:
        raise ValueError(f'{name}: M={M} and Dv={Dv} must be multiples of 4')
    return BH, L, M, Dv


# the bytes each input's base must be a multiple of: the forward loads four
# values of a row at a time in the input's own type (16 bytes of float32, 8
# of bfloat16), the backward passes 16 bytes of float32
_CLA_FWD_ALIGN = {torch.float32: 16, torch.bfloat16: 8}
_CLA_BWD_ALIGN = {torch.float32: 16}


def _check_cla_fwd_inputs(q2, k2, v2):
    """(BH, L, M, Dv) for ``cla_fwd``: [BH, L, M] features and [BH, L, Dv]
    v, contiguous CUDA tensors, each float32 or bfloat16 on its own, M and
    Dv multiples of 4, each base on its dtype's boundary
    (``_CLA_FWD_ALIGN``); raises otherwise."""
    dims = _check_cla_inputs('cla_fwd', q2, k2, v2, (torch.float32, torch.bfloat16))
    _check_aligned('cla_fwd', (('phi_q', q2), ('phi_k', k2), ('v', v2)), _CLA_FWD_ALIGN)
    return dims


def _cla_fwd_cuda(q2, k2, v2, eps=EPS) -> torch.Tensor:
    """Launch ``cla_fwd`` on [BH, L, M] features and [BH, L, Dv] v, each
    float32 or bfloat16; returns [BH, L, Dv] float32.  The kernel loads
    four values of a row at a time in each input's own type (16 bytes of
    float32, 8 of bfloat16) and widens them to float32, so each input must
    start on that boundary (``_check_cla_fwd_inputs``)."""
    BH, L, M, Dv = _check_cla_fwd_inputs(q2, k2, v2)
    out = torch.empty(BH, L, Dv, dtype=torch.float32, device=q2.device)
    lib = _cla_lib()
    bf16 = [int(t.dtype == torch.bfloat16) for t in (q2, k2, v2)]
    err = lib.cla_fwd(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), out.data_ptr(),
                      BH, L, M, Dv, *bf16, eps,
                      torch.cuda.current_stream(q2.device).cuda_stream)
    _build.check(lib, err, 'cla_fwd')
    _build.LAUNCHES['cla_fwd'] += 1
    return out


def _cla_bwd_a_cuda(q2, k2, v2, g2, eps=EPS):
    """Launch ``cla_bwd_a`` (pass A) on float32 [BH, L, M] features and
    [BH, L, Dv] v and g; returns dphi_q [BH, L, M], u [BH, L, Dv] and
    w [BH, L], float32.  The kernel loads rows 16 bytes at a time, so each
    input must start on a 16-byte boundary."""
    BH, L, M, Dv = _check_cla_inputs('cla_bwd_a', q2, k2, v2, (torch.float32,))
    _check_cuda('g', g2, (torch.float32,), 3, q2.device)
    if g2.shape != v2.shape:
        raise ValueError(f'cla_bwd_a: g {tuple(g2.shape)} vs v {tuple(v2.shape)}')
    _check_aligned('cla_bwd_a', (('phi_q', q2), ('phi_k', k2), ('v', v2), ('g', g2)),
                   _CLA_BWD_ALIGN)
    dq = torch.empty_like(q2)
    u = torch.empty_like(v2)
    w = torch.empty(BH, L, dtype=torch.float32, device=q2.device)
    lib = _cla_lib()
    err = lib.cla_bwd_a(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), g2.data_ptr(),
                        dq.data_ptr(), u.data_ptr(), w.data_ptr(), BH, L, M, Dv,
                        eps, torch.cuda.current_stream(q2.device).cuda_stream)
    _build.check(lib, err, 'cla_bwd_a')
    _build.LAUNCHES['cla_bwd_a'] += 1
    return dq, u, w


def _cla_bwd_b_cuda(q2, k2, v2, u, w):
    """Launch ``cla_bwd_b`` (pass B) on the inputs of pass A and its (u, w);
    returns dphi_k [BH, L, M] and dv [BH, L, Dv], float32.  phi_q, phi_k,
    v and u must start on a 16-byte boundary (16-byte row loads); w is read
    a value at a time."""
    BH, L, M, Dv = _check_cla_inputs('cla_bwd_b', q2, k2, v2, (torch.float32,))
    _check_cuda('u', u, (torch.float32,), 3, q2.device)
    _check_cuda('w', w, (torch.float32,), 2, q2.device)
    if u.shape != v2.shape or tuple(w.shape) != (BH, L):
        raise ValueError(f'cla_bwd_b: u {tuple(u.shape)} w {tuple(w.shape)} vs '
                         f'v {tuple(v2.shape)}')
    _check_aligned('cla_bwd_b', (('phi_q', q2), ('phi_k', k2), ('v', v2), ('u', u)),
                   _CLA_BWD_ALIGN)
    dk = torch.empty_like(k2)
    dv = torch.empty_like(v2)
    lib = _cla_lib()
    err = lib.cla_bwd_b(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), u.data_ptr(),
                        w.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, L, M, Dv,
                        torch.cuda.current_stream(q2.device).cuda_stream)
    _build.check(lib, err, 'cla_bwd_b')
    _build.LAUNCHES['cla_bwd_b'] += 1
    return dk, dv


def _aligned(t: torch.Tensor, align) -> torch.Tensor:
    """``t`` (contiguous) on the boundary ``align`` gives its dtype: a view
    off it is copied again in its own dtype, which moves its address and
    nothing else (values, device and shape stay); a dtype ``align`` does
    not name is left for the kernel's check to refuse."""
    return t.clone() if t.data_ptr() % align.get(t.dtype, 1) else t


def _f32_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous float32 tensor on a 16-byte boundary."""
    return _aligned(t.to(torch.float32).contiguous(), _CLA_BWD_ALIGN)


def _cla_fwd_aligned_cuda(q2, k2, v2, eps=EPS) -> torch.Tensor:
    """The composed op's forward on the card: ``cla_fwd`` on the inputs in
    their own dtypes, a view off the boundary its loads need
    (``_CLA_FWD_ALIGN``) copied again first; returns out (float32)."""
    return _cla_fwd_cuda(*(_aligned(t, _CLA_FWD_ALIGN) for t in (q2, k2, v2)), eps)


def _cla_bwd_cuda(q2, k2, v2, g, eps=EPS):
    """The composed op's backward on the card: ``cla_bwd_a`` then
    ``cla_bwd_b`` on float32 copies of the inputs and the gradient, as JAX
    casts before its backward kernels, each aligned for their 16-byte
    loads; returns dphi_q, dphi_k, dv (float32)."""
    q, k, v, g = (_f32_aligned(t) for t in (q2, k2, v2, g))
    dq, u, w = _cla_bwd_a_cuda(q, k, v, g, eps)
    dk, dv = _cla_bwd_b_cuda(q, k, v, u, w)
    return dq, dk, dv


class _CausalLinearAttention(torch.autograd.Function):
    """[BH, L, M] features phi_q, phi_k and [BH, L, Dv] v -> [BH, L, Dv] in
    the accumulation type.  Saves the three inputs; the gradients come back
    in each input's own type."""

    @staticmethod
    def forward(ctx, q2, k2, v2, chunk, eps):
        if q2.device.type == 'cpu':
            out = _cla_fwd_plain(q2, k2, v2, chunk, eps)
        else:
            out = _cla_fwd_aligned_cuda(q2, k2, v2, eps)
        ctx.save_for_backward(q2, k2, v2)
        ctx.chunk, ctx.eps = chunk, eps
        return out

    @staticmethod
    def backward(ctx, g):
        q2, k2, v2 = ctx.saved_tensors
        if q2.device.type == 'cpu':
            dq, u, w = _cla_bwd_a_plain(q2, k2, v2, g, ctx.chunk, ctx.eps)
            dk, dv = _cla_bwd_b_plain(q2, k2, v2, u, w, ctx.chunk)
        else:
            dq, dk, dv = _cla_bwd_cuda(q2, k2, v2, g, ctx.eps)
        return dq.to(q2.dtype), dk.to(k2.dtype), dv.to(v2.dtype), None, None


def causal_linear_attention(phi_q: torch.Tensor, phi_k: torch.Tensor,
                            v: torch.Tensor, chunk: int = CHUNK,
                            eps: float = EPS) -> torch.Tensor:
    """Normalized causal linear attention over precomputed features:
    phi_q, phi_k [..., L, M] non-negative, v [..., L, Dv].  Returns
    [..., L, Dv] float32 (float64 for float64 features), differentiable in
    all three inputs, each gradient in its input's type.  With
    :func:`favor_features` it composes FAVOR+ attention, the same function
    as :func:`favor_causal_attention`.

    CPU tensors run the plain versions: the chunked scan (L zero-padded to
    a ``chunk`` multiple) forward, :func:`_cla_bwd_a_plain` and
    :func:`_cla_bwd_b_plain` backward.  CUDA tensors launch ``cla_fwd``
    forward, which reads each input as float32 or bfloat16 in its own type,
    four values of a row a load, and widens them to float32; and, on
    float32 casts of the inputs and the gradient, ``cla_bwd_a`` then
    ``cla_bwd_b`` backward, which load rows 16 bytes at a time.  A view
    off the boundary its loads need is copied again first (in its own
    dtype forward).  The kernels take 64-row chunks whatever ``chunk`` is,
    M and Dv multiples of 4, mask the ragged last chunk themselves, and
    raise on what they cannot take."""
    *lead, L, M = phi_q.shape
    Dv = v.shape[-1]
    bh = math.prod(lead)
    out = _CausalLinearAttention.apply(
        phi_q.reshape(bh, L, M).contiguous(), phi_k.reshape(bh, L, M).contiguous(),
        v.reshape(bh, L, Dv).contiguous(), chunk, eps)
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
