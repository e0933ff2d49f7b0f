"""The stage-1 decode step's cache work with a clock per element,
``ops.attention.txl_decode_attention_pe``, on the CPU.

* On CPU tensors it is the plain composition, ``write_row_pe`` on k and v
  then ``full_decode_attention_pe`` with the r_w / r_r biases on q, bit for
  bit: the output and both caches, in the three layouts, f32 and bf16, at
  clocks that hit the write clamp (K - 1, K + 3) and the clamp of the
  distance window (R + 3).
* The CUDA wrapper refuses CPU tensors, and its check refuses each input
  the kernel does not take (a head width over 256, too many heads, dtypes
  that differ, an unknown layout, ...) before anything is built; the
  widths the stage-1 configs use pass it.
* ``decode_step_pe`` through it is the former step (the two writes and the
  plain attention inline) bit for bit at staggered clocks, and at a
  uniform clock it still reproduces the forward, in every layout.

The kernel itself runs on the card: ``tests/test_torch_txl_decode_attn_card.py``."""

import pytest
import torch

from emo_disentanger_tpu_torch.models.txl import PlainTransformer
from emo_disentanger_tpu_torch.ops import _build
from emo_disentanger_tpu_torch.ops import attention as attn

LAYOUTS = ('khd', 'hkd', 'dk')
B, K, R, H, DH = 6, 16, 24, 2, 8
CLOCKS = (0, 1, 8, K - 1, K + 3, R + 3)
SCALE = DH ** -0.5
# the port's decode against its own forward (``test_torch_txl.DECODE_TOL``)
DECODE_TOL = 1e-4


def _inputs(layout, dtype=torch.float32, *, b=B, k=K, r=R, h=H, dh=DH, seed=0):
    """q, k_new, v_new (row views of one [b, 3 h dh] projection, as the
    model's), the k and v caches and r_heads in ``layout``, the biases, the
    clocks ``CLOCKS`` (cycled over the b elements)."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dtype)  # noqa: E731
    q, k_new, v_new = (x.reshape(b, h, dh)
                       for x in rnd(b, 3 * h * dh).chunk(3, -1))
    shape = {'khd': (b, k, h, dh), 'hkd': (b, h, k, dh), 'dk': (b, h, dh, k)}
    r_shape = (r, h, dh) if layout == 'khd' else (h, dh, r)
    t = torch.tensor([CLOCKS[i % len(CLOCKS)] for i in range(b)])
    return (q, k_new, v_new, rnd(*shape[layout]), rnd(*shape[layout]), t,
            rnd(*r_shape), 0.1 * rnd(h, dh), 0.1 * rnd(h, dh))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('layout', LAYOUTS)
def test_cpu_is_the_plain_composition_bitwise(layout, dtype):
    q, k_new, v_new, kc, vc, t, r, r_w, r_r = _inputs(layout, dtype)
    kp, vp = kc.clone(), vc.clone()
    got = attn.txl_decode_attention_pe(q, k_new, v_new, kc, vc, t, r, r_w,
                                       r_r, scale=SCALE, layout=layout)
    attn.write_row_pe(kp, k_new, t, layout)
    attn.write_row_pe(vp, v_new, t, layout)
    want = attn.full_decode_attention_pe(
        q + r_w.to(dtype), kp, vp, t, scale=SCALE,
        rel=(q + r_r.to(dtype), r), layout=layout)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(kc, kp) and torch.equal(vc, vp)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('the wrapper reached the kernel library')
    monkeypatch.setattr(_build, 'library', refuse)
    launches = dict(_build.LAUNCHES)
    yield
    assert dict(_build.LAUNCHES) == launches


def test_cuda_wrapper_refuses_cpu_tensors(no_build):
    args = _inputs('khd')
    with pytest.raises(ValueError, match='CUDA tensors'):
        attn._txl_decode_attention_cuda(*args, scale=SCALE, layout='khd')


def _bad(case):
    """(inputs, layout, the error's words) of one refused case."""
    args = list(_inputs('khd'))
    layout = 'khd'
    if case == 'head width over 256':
        args = list(_inputs('khd', b=2, k=4, r=4, h=1, dh=257))
        return args, layout, '1 <= Dh <= 256'
    if case == 'too many heads':
        args = list(_inputs('khd', b=2, k=4, r=4, h=40, dh=64))
        return args, layout, 'threads a head'
    if case == 'cache dtype differs':
        args[3] = args[3].to(torch.bfloat16)
        return args, layout, 'k_cache'
    if case == 'new row dtype differs':
        args[2] = args[2].to(torch.bfloat16)
        return args, layout, 'v_new'
    if case == 'float16':
        args = list(_inputs('khd', torch.float16))
        return args, layout, 'float32 or bfloat16'
    if case == 'unknown layout':
        return args, 'kdh', 'unknown cache layout'
    if case == 'layout of the cache':
        return args, 'hkd', 'k_cache'
    if case == 'distance rows':
        args = list(_inputs('khd', r=K - 1))
        return args, layout, 'distance rows'
    if case == 'clock dtype':
        args[5] = args[5].int()
        return args, layout, 'int64'
    if case == 'clock count':
        args[5] = args[5][:-1]
        return args, layout, 't:'
    if case == 'v strides differ':
        args[4] = args[4].transpose(0, 1).contiguous().transpose(0, 1)
        return args, layout, 'strides differ'
    if case == 'q rows':
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
        return args, layout, 'q must hold'
    if case == 'bias shape':
        args[7] = args[7][:1]
        return args, layout, 'r_w_bias'
    raise KeyError(case)


@pytest.mark.parametrize('case', [
    'head width over 256', 'too many heads', 'cache dtype differs',
    'new row dtype differs', 'float16', 'unknown layout',
    'layout of the cache', 'distance rows', 'clock dtype', 'clock count',
    'v strides differ', 'q rows', 'bias shape'])
def test_check_refuses(case, no_build):
    args, layout, words = _bad(case)
    with pytest.raises(ValueError, match=words):
        attn._check_txl_inputs(*args, layout)


@pytest.mark.parametrize('h,dh', [(8, 64), (6, 48), (4, 36), (8, 256),
                                  (32, 64)])
@pytest.mark.parametrize('layout', LAYOUTS)
def test_check_takes_the_widths(layout, h, dh, no_build):
    """The stage-1 configs' 8 heads of 64, odd widths, the widest head and
    the most heads of 64."""
    args = _inputs(layout, torch.bfloat16, b=2, k=4, r=5, h=h, dh=dh)
    assert attn._check_txl_inputs(*args, layout) == (2, 4, 5, h, dh)


def _model():
    g = torch.Generator().manual_seed(1)
    m = PlainTransformer(40, n_layer=2, n_head=4, d_model=64, d_ff=128,
                         d_embed=64, dropout=0.0, device='cpu', generator=g)
    with torch.no_grad():
        for p in m.parameters():          # larger than N(0, 0.01), so
            p.mul_(5.0)                   # attention is far from uniform
    return m.eval()


def _former_step(model, token, t, cache, layout):
    """The decode_step_pe body before the wrapper: both writes and the plain
    attention inline."""
    h = model._embed_step(token)
    dec = model.decoder
    for i, layer in enumerate(dec.layers):
        a = layer.dec_attn
        q, k, v = a._qkv_step(h)
        attn.write_row_pe(cache['k'][i], k, t, layout)
        attn.write_row_pe(cache['v'][i], v, t, layout)
        out = attn.full_decode_attention_pe(
            q + dec.r_w_bias.to(q.dtype), cache['k'][i], cache['v'][i], t,
            scale=1.0 / a.d_head ** 0.5,
            rel=(q + dec.r_r_bias.to(q.dtype), cache['r'][i]), layout=layout)
        h = layer.pos_ff(a._out_step(h, out), deterministic=True)
    return model._logits(h)[:, 0]


@pytest.mark.parametrize('layout', LAYOUTS)
def test_decode_step_pe_is_the_former_step_bitwise(layout):
    """Staggered clocks, one element past the cache's end."""
    model = _model()
    g = torch.Generator().manual_seed(2)
    tok = torch.randint(0, 39, (3, 14), generator=g)
    start = torch.tensor([0, 5, 9])
    a = model.init_decode_cache(3, 16, layout)
    b = model.init_decode_cache(3, 16, layout)
    with torch.no_grad():
        for i in range(tok.shape[1]):
            t = start + i
            got, _ = model.decode_step_pe(tok[:, i], t, a, layout)
            want = _former_step(model, tok[:, i], t, b, layout)
            assert torch.equal(got, want), i
    assert torch.equal(a['k'], b['k']) and torch.equal(a['v'], b['v'])


@pytest.mark.parametrize('layout', LAYOUTS)
def test_decode_step_pe_reproduces_the_forward(layout):
    model = _model()
    g = torch.Generator().manual_seed(3)
    tok = torch.randint(0, 39, (2, 12), generator=g)
    with torch.no_grad():
        ref, _ = model(tok)
        cache = model.init_decode_cache(2, 16, layout)
        steps = [model.decode_step_pe(tok[:, i], torch.full((2,), i), cache,
                                      layout)[0] for i in range(tok.shape[1])]
    torch.testing.assert_close(torch.stack(steps, 1), ref, rtol=0,
                               atol=DECODE_TOL)
