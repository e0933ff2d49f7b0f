"""The work counts against values worked by hand at one small shape."""

import pytest

from portbench import work

CFG = {'kind': 'performer', 'n_layer': 2, 'n_head': 2, 'd_model': 8,
       'd_ff': 16, 'n_features': 4, 'n_segment_types': 2,
       'training': {'accum_steps': 1}}


def test_layer_and_dense_params():
    # 4 (8*8 + 8) + (8*16 + 16) + (16*8 + 8) + 4*8 = 288 + 144 + 136 + 32
    assert work.layer_params(8, 16) == 600
    # 2 layers + head 8*10 + 10
    assert work.dense_params(CFG, 10) == 1290
    assert work.all_params(CFG, 10) == 1290 + 80 + 16


def test_favor_counts():
    # bh 3, L 5, Dh 8, Dv 8, M 4: a position forward 4*8*4 + 4*4*8 + 4*4
    fwd, bwd = work.favor_flops(3, 5, 8, 8, 4)
    assert fwd == 15 * (128 + 128 + 16)
    assert bwd == 15 * (256 + 320 + 32)
    fb, bb = work.favor_bytes(3, 5, 8, 8, 4, 2)
    assert fb == 15 * (16 + 16) * 2 + 8 * 4 * 4
    assert bb == 15 * (32 + 24) * 2 + 8 * 4 * 4


def test_causal_attention_counts():
    fwd, bwd = work.causal_attention_flops(2, 3, 4)
    assert fwd == 2 * 2 * 4 * (2 * 3 * 4 / 2) and bwd == 2 * fwd


def test_train_step_work():
    flops, nbytes = work.train_step_work(CFG, 10, 2, 5)
    attn = 2 * sum(work.favor_flops(4, 5, 4, 4, 4))
    assert flops == 6.0 * 1290 * 10 + attn
    assert nbytes == 28 * (1290 + 96) + 10 * 24


def test_train_step_adam_bytes_shared_over_accumulated_micro_batches():
    accum = dict(CFG, training={'accum_steps': 2})
    flops, nbytes = work.train_step_work(accum, 10, 2, 5)
    assert flops == work.train_step_work(CFG, 10, 2, 5)[0]
    assert nbytes == 28 * (1290 + 96) / 2 + 10 * 24


def test_decode_counts_and_least_time():
    gpt = dict(CFG, kind='gpt2')
    flops, nbytes = work.decode_step_work(gpt, 10, slots=3, live_rows=7,
                                          w_elem=2)
    assert flops == 2.0 * 1290 * 3 + 2 * 4.0 * 2 * 4 * 7
    assert nbytes == (1290 * 2 + 3 * 16 * 2 + 3 * 10 * 4
                      + 2 * (2 * 7 * 8 * 2 + 3 * 2 * 8 * 2))
    assert work.kv_prefix_bytes(gpt, 7, 2) == 2 * 2.0 * 7 * 8 * 2
    # state: 4 * H * M * (Dh + 1) = 4 * 2 * 4 * 5
    assert work.performer_state_bytes(CFG) == 160
    assert work.performer_decode_layer_bytes(CFG, 3, 2) == 600 * 2 + 3 * (320 + 32)
    assert work.least_seconds(989e12, 0, 'bfloat16') == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12, 'bfloat16') == pytest.approx(1.0)
