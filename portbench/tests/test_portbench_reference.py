"""The plain reference against the port's plain CPU versions at a tiny
size: the same logits, the same batches, the same features and the same
dropout masks, from the same inputs."""

import os

import numpy as np
import pytest
import torch

from portbench import inputs, traffic
from portbench.reference import data as ref_data
from portbench.reference import models, serve as ref_serve, train as ref_train
from portbench.tests.tiny import tiny


def _program(cfg, V, dtype=None):
    from portbench.drivers.train import _build_model
    return _build_model(cfg, V, 'cpu', dtype)


@pytest.mark.parametrize('cell', ['performer.train', 'gpt2.train'])
def test_forward_matches_the_port(cell):
    _, cfg = tiny(cell)
    V = 327
    P = inputs.make_weights(cfg, V, 11, 'cpu')
    m = _program(cfg, V)
    m.load_state_dict(P)
    m.eval()
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, V - 1, (2, 200), generator=g)
    seg = torch.randint(0, 2, (2, 200), generator=g)
    om = inputs.initial_omegas(cfg, 3, 'cpu') if cfg['kind'] == 'performer' else None
    with torch.no_grad():
        got = m(tok, om, seg) if om is not None else m(tok, seg)
        ref = models.forward(P, cfg, tok, seg, om)
    assert torch.allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_chunked_favor_is_the_masked_product():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 300, 8, generator=g, dtype=torch.float64)
               for _ in range(3))
    om = models.draw_features(8, 16, torch.Generator().manual_seed(2)).double()
    got = models.favor_attention(q, k, v, om, chunk=64)
    pq = models.favor_features(q, om, True)
    pk = models.favor_features(k, om, False)
    s = (pq @ pk.transpose(-1, -2)).tril()
    ref = (s @ v) / (s.sum(-1, keepdim=True) + 1e-6)
    assert torch.allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_features_are_the_port_draw():
    from emo_disentanger_tpu_torch.ops.linear_attention import draw_orthogonal_features
    a = draw_orthogonal_features(64, 128, torch.Generator().manual_seed(9))
    b = models.draw_features(64, 128, torch.Generator().manual_seed(9))
    assert torch.equal(a, b)


def test_batches_are_the_port_loader(tmp_path):
    from emo_disentanger_tpu_torch.core.vocab import Vocab
    from emo_disentanger_tpu_torch.data.datasets import Stage2Dataset
    names = traffic.write_corpus(str(tmp_path), 5, 6, 4)
    e2w, w2e = traffic.dictionary()
    ds = Stage2Dataset(os.path.join(tmp_path, 'events'), Vocab(e2w, w2e),
                       pieces=names, model_dec_seqlen=96, seed=7)
    ours = ref_data.batches(os.path.join(tmp_path, 'events'), names, e2w, 96, 3, 7)
    for _ in range(2):                    # two epochs
        for b in ds.batches(3, shuffle=True):
            r = next(ours)
            for k, kk in (('dec_inp', 'tokens'), ('dec_tgt', 'targets'),
                          ('track_mask', 'seg')):
                assert np.array_equal(b[k], r[kk])


@pytest.mark.parametrize('cell', ['performer.train', 'gpt2.train'])
def test_dropout_replay_draws_the_program_masks(cell):
    _, cfg = tiny(cell)
    m = _program(cfg, 327, torch.bfloat16)
    m.train()
    cap = []
    for mod in m.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.register_forward_hook(lambda mod, i, o: cap.append((i[0], o)))
    tok = torch.randint(0, 326, (2, 40))
    seg = torch.zeros(2, 40, dtype=torch.long)
    torch.manual_seed(4)
    if cfg['kind'] == 'performer':
        m(tok, inputs.initial_omegas(cfg, 3, 'cpu'), seg)
    else:
        m(tok, seg)
    torch.manual_seed(4)
    rep = ref_train.DropoutReplay(models.drop_shapes(cfg, 2, 40), 0.1,
                                  torch.bfloat16, 'cpu')
    assert len(cap) == len(rep.masks)
    for (i, o), mask in zip(cap, rep.masks):
        nz = i != 0
        assert torch.equal((o != 0)[nz], mask[nz])


def test_song_layout_marks_the_chosen_tokens():
    e2w, _ = traffic.dictionary()
    lead, full = e2w['Track_LeadSheet'], e2w['Track_Full']
    bars = [[e2w['Bar_None'], e2w['Beat_0']], [e2w['Bar_None']]]
    a, b = e2w['Note_Octave_5'], e2w['Beat_4']
    stream = [1, 2, 3, lead] + bars[0] + [full, a, b, lead] + bars[1] + [full, a]
    seg, chosen = ref_serve.song_layout(stream, 4, bars, e2w)
    assert seg == [0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1]
    assert chosen == [False] * 7 + [True] * 3 + [False] * 2 + [True]
    with pytest.raises(ValueError):
        ref_serve.song_layout(stream[:4] + [a] + stream[5:], 4, bars, e2w)
