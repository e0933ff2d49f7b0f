"""The work each measured operation needs: FLOPs and bytes of the
algorithm at the cell's precision, and the H100's peaks.

These count the algorithm, never an implementation: each input byte is read
once and each output byte written once, whatever a kernel reads again; a
causal product counts the positions the recurrence needs; decode attention
reads the live cache prefix only.  A later kernel that drops a pass or a
copy moves the measured time, not these counts.

Peaks: NVIDIA H100 SXM data sheet, dense (989 TFLOP/s bf16 on the tensor
cores, 67 TFLOP/s f32 outside them, 3.35 TB/s HBM3), at the card's full
700 W; a run prints the card's power limit beside its numbers.
"""

from __future__ import annotations

from typing import Tuple

PEAK_FLOP_PER_S = {'bfloat16': 989e12, 'float32': 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {'bfloat16': 2, 'float32': 4}
# Adam over float32 master weights: read p, g, m, v and write p, m, v
ADAM_BYTES_PER_PARAM = 7 * 4


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations at
    the dtype's peak and the bytes at the memory's."""
    return max(flops / PEAK_FLOP_PER_S[dtype], nbytes / HBM_BYTES_PER_S)


def layer_params(d_model: int, d_ff: int) -> int:
    """One block of either stage-2 model: four d x d projections (GPT-2's
    fused qkv is three of them), the two FF matrices, their biases and two
    LayerNorms."""
    D, F = d_model, d_ff
    return 4 * (D * D + D) + (D * F + F) + (F * D + D) + 4 * D


def head_params(d_model: int, vocab: int) -> int:
    return d_model * vocab + vocab


def dense_params(cfg: dict, vocab: int) -> int:
    """Parameters that take part in a matrix product for every token: the
    blocks and the vocabulary head, not the embedding tables."""
    return (cfg['n_layer'] * layer_params(cfg['d_model'], cfg['d_ff'])
            + head_params(cfg['d_model'], vocab))


def all_params(cfg: dict, vocab: int) -> int:
    D = cfg['d_model']
    return dense_params(cfg, vocab) + vocab * D + cfg['n_segment_types'] * D


# ---------------------------------------------------------------- FAVOR+

def favor_flops(bh: int, L: int, d_head: int, d_v: int, m: int
                ) -> Tuple[float, float]:
    """(forward, backward) FLOPs of causal FAVOR+ attention over ``bh``
    rows of ``L`` positions.  Forward, a position: the features of q and k
    (2 Dh M each), S += phi_k v^T and phi_q^T S (2 M Dv each), z and the
    denominator (2 M each).  Backward, with q, k and v saved (the features
    and the prefix state are worked out again): the features of q and k
    (4 Dh M), the prefix S again, dphi_q = S u + w z, the suffix R, dv and
    dphi_k (2 M Dv each, and 2 M for each z-like term: z, dphi_q's w z, r,
    dphi_k's r), and dx through the features (2 Dh M for each of q, k)."""
    pos = bh * L
    fwd = pos * (4 * d_head * m + 4 * m * d_v + 4 * m)
    bwd = pos * (8 * d_head * m + 10 * m * d_v + 8 * m)
    return float(fwd), float(bwd)


def favor_bytes(bh: int, L: int, d_head: int, d_v: int, m: int, elem: int
                ) -> Tuple[float, float]:
    """(forward, backward) bytes: forward reads q, k, v and omega and writes
    the output; backward reads q, k, v, the output's gradient and omega and
    writes dq, dk, dv.  omega is float32."""
    pos = bh * L
    omega = d_head * m * 4
    fwd = pos * (2 * d_head + 2 * d_v) * elem + omega
    bwd = pos * (4 * d_head + 3 * d_v) * elem + omega
    return float(fwd), float(bwd)


def favor_train_seconds(cfg: dict, batch: int, L: int, dtype: str) -> float:
    """Least time of one train step's FAVOR+ work, forward and backward,
    every layer (the work of the key max, forward and both backward passes
    together)."""
    H = cfg['n_head']
    Dh = cfg['d_model'] // H
    M = cfg['n_features']
    fl = sum(favor_flops(batch * H, L, Dh, Dh, M))
    by = sum(favor_bytes(batch * H, L, Dh, Dh, M, ELEM_BYTES[dtype]))
    return cfg['n_layer'] * least_seconds(fl, by, dtype)


# ---------------------------------------------------------- dense attention

def causal_attention_flops(bh: int, L: int, d_head: int) -> Tuple[float, float]:
    """(forward, backward) FLOPs of causal softmax attention: q k^T and
    p v over the L (L + 1) / 2 pairs the mask keeps, 2 Dh each; the
    backward takes twice the forward's products (dq, dk; dp, dv)."""
    pairs = bh * L * (L + 1) / 2
    fwd = 2 * 2 * d_head * pairs
    return float(fwd), float(2 * fwd)


# ------------------------------------------------------------- train step

def train_step_work(cfg: dict, vocab: int, batch: int, L: int
                    ) -> Tuple[float, float]:
    """(FLOPs, bytes) one micro-batch of training needs: 6 x dense
    parameters x tokens, the attention forward and backward, and the Adam
    update over float32 master weights once every ``accum_steps``
    micro-batches (its bytes shared out over them)."""
    H = cfg['n_head']
    Dh = cfg['d_model'] // H
    tokens = batch * L
    flops = 6.0 * dense_params(cfg, vocab) * tokens
    if cfg['kind'] == 'performer':
        flops += cfg['n_layer'] * sum(favor_flops(batch * H, L, Dh, Dh,
                                                  cfg['n_features']))
    else:
        flops += cfg['n_layer'] * sum(causal_attention_flops(batch * H, L, Dh))
    nbytes = (ADAM_BYTES_PER_PARAM * all_params(cfg, vocab)
              / cfg['training']['accum_steps'])
    nbytes += tokens * 3 * 8                 # tokens, targets, segments
    return flops, float(nbytes)


# ------------------------------------------------------------ decode step

def performer_state_bytes(cfg: dict) -> int:
    """One slot's FAVOR+ state of one layer, float32: S [H, Dh, M] and
    z [H, M]."""
    H = cfg['n_head']
    Dh = cfg['d_model'] // H
    M = cfg['n_features']
    return 4 * H * M * (Dh + 1)


def performer_decode_layer_bytes(cfg: dict, slots: float, w_elem: int) -> float:
    """Bytes of one Performer decode layer for ``slots`` live slots: the
    layer's weights, each slot's state read and written, its input row read
    and output row written."""
    D = cfg['d_model']
    return (layer_params(D, cfg['d_ff']) * w_elem
            + slots * (2 * performer_state_bytes(cfg) + 2 * D * w_elem))


def decode_step_work(cfg: dict, vocab: int, slots: float, live_rows: float,
                     w_elem: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode step for ``slots`` live slots.  Bytes:
    every weight once (embedding rows per slot), the Performer's state read
    and written for each live slot, or GPT-2's live cache prefix
    (``live_rows`` = the rows up to each live slot's clock, summed) read and
    its new k, v rows written; the float32 logits written."""
    D, L_ = cfg['d_model'], cfg['n_layer']
    H = cfg['n_head']
    Dh = D // H
    flops = 2.0 * dense_params(cfg, vocab) * slots
    nbytes = (dense_params(cfg, vocab) * w_elem + slots * 2 * D * w_elem
              + slots * vocab * 4)
    if cfg['kind'] == 'performer':
        M = cfg['n_features']
        flops += L_ * slots * H * (4 * Dh * M + 4 * M * Dh + 4 * M)
        nbytes += L_ * slots * 2 * performer_state_bytes(cfg)
    else:
        flops += L_ * 4.0 * H * Dh * live_rows
        nbytes += L_ * (2 * live_rows * D * w_elem + slots * 2 * D * w_elem)
    return float(flops), float(nbytes)


def kv_prefix_bytes(cfg: dict, live_rows: float, w_elem: int) -> float:
    """GPT-2 decode attention's bytes over all layers: the live k and v
    prefix read, the new rows written (counted in ``live_rows``)."""
    return cfg['n_layer'] * 2.0 * live_rows * cfg['d_model'] * w_elem
