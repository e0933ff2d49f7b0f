"""The work a stage-1 Transformer-XL decode step needs: FLOPs and bytes of
the algorithm at the cell's precision, counted from the program's counters
over the traced steps (``utils.profiling.COUNTS``: ``serve.steps``,
``serve.slot_steps``, ``serve.live_rows``, the running slots' clocks at
each step's start, summed; a step attends to clock + 1 rows).

As ``work`` counts them: each input byte read once and each output byte
written once, whatever a kernel reads again; decode attention reads the
live cache prefix, not the whole padded cache, so a live-prefix kernel
moves the measured time, not these counts.  The peaks are ``work``'s.
"""

from __future__ import annotations

from typing import Tuple


def layer_params(d_model: int, d_ff: int) -> int:
    """The weights one decode step reads in a layer: the fused bias-free
    qkv (3 d x d) and ``o_net`` (d x d), the feed-forward's two matrices
    and their biases, two LayerNorms.  ``r_net`` is not read: the decode
    reads its position heads from the cache."""
    D, F = d_model, d_ff
    return 4 * D * D + (D * F + F) + (F * D + D) + 4 * D


def dense_params(cfg: dict, vocab: int) -> int:
    """Parameters that take part in a matrix product for every token: the
    layers and the vocabulary head, not the embedding table."""
    D = cfg['d_model']
    return cfg['n_layer'] * layer_params(D, cfg['d_ff']) + D * vocab + vocab


def attn_bytes(cfg: dict, steps: float, slot_steps: float, live_rows: float,
               elem: int) -> float:
    """The least bytes of the decode's cache work over all layers: the k and
    v rows up to each running slot's clock read (``live_rows`` +
    ``slot_steps`` rows: clock + 1 a slot-step), its new k and v rows
    written, and the position heads of the distances read, one row a
    distance a step (at least the mean clock + 1 of the step's slots)."""
    if slot_steps <= 0:
        return 0.0
    D = cfg['d_model']
    rows = live_rows + slot_steps
    heads = steps * (live_rows / slot_steps + 1)
    return cfg['n_layer'] * D * elem * (2.0 * rows + 2.0 * slot_steps + heads)


def attn_flops(cfg: dict, slot_steps: float, live_rows: float) -> float:
    """FLOPs of the decode attention over all layers: q . k, the relative
    term (q + r_r) . r and p v, 2 d each over the clock + 1 rows a running
    slot attends to."""
    return cfg['n_layer'] * 6.0 * cfg['d_model'] * (live_rows + slot_steps)


def step_work(cfg: dict, vocab: int, steps: float, slot_steps: float,
              live_rows: float, elem: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of ``steps`` decode steps over their running slots.
    Bytes: every weight once a step, each running slot's embedding row, its
    float32 logits written, and the cache work (``attn_bytes``)."""
    D = cfg['d_model']
    flops = 2.0 * dense_params(cfg, vocab) * slot_steps
    flops += attn_flops(cfg, slot_steps, live_rows)
    nbytes = (steps * dense_params(cfg, vocab) * elem
              + slot_steps * (D * elem + vocab * 4)
              + attn_bytes(cfg, steps, slot_steps, live_rows, elem))
    return float(flops), float(nbytes)
