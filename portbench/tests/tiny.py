"""Tiny copies of the cells, for the CPU: every width and count cut, the
structure of each cell kept."""

import copy

from portbench import common

# limits at this size, between the readings of the program (bf16 on the
# CPU's plain versions) and of its control (float8 operands), three seeds
# each (serving: five, the queue's refilled songs included; program at
# most 0.100 and 0.077, control at least 0.514 and 0.798): bf16 rounds a
# tiny model's few sums relatively more
TINY_LIMITS = {
    'performer.train': {'grad': 0.012, 'change': 0.016},
    'gpt2.train': {'loss': 2e-5, 'grad': 0.008, 'change': 0.004},
    'performer.serve': {'gap': 0.25, 'unfinished': 0},
    'gpt2.serve': {'gap': 0.4, 'unfinished': 0},
}


def tiny(name: str):
    cell = copy.deepcopy(common.workload(name))
    cfg = copy.deepcopy(common.config(cell['config']))
    cfg.update(n_layer=2, n_head=2, d_model=32, d_ff=64, d_embed=32,
               n_features=16)
    cell['limits'] = dict(TINY_LIMITS[name])
    t = cell['traffic']
    if cell['driver'] == 'train':
        t.update(batch=2, seq_len=64, corpus_pieces=8, corpus_bars=4)
        cell['check']['rows'] = 1
        cell['trace'] = {'skip': 1, 'steps': 2}
    else:
        t.update(slots=8, queue=20, max_events=400, bars=[6, 10])
        if 'cache_len' in t:
            t.update(cache_len=512, window=128, reanchor_margin=32)
        cell['trace'] = {'skip': 40, 'steps': 8}
    return cell, cfg
