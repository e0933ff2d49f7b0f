"""The stage-1 decode attention kernel (``csrc/txl_decode_attn.cu``) on the
card, against the plain composition (``write_row_pe`` on k and v, then
``full_decode_attention_pe``) evaluated in float32 on the same inputs.

* The cell's widths (B 256, K = R = 1536, 8 heads of 64) in 'khd', 'hkd'
  and 'dk', bf16 and f32, at mixed clocks 0, 1, 203, 499, K - 1 and K + 5
  (a dead slot past the cache); odd widths (6 heads of 48; 4 heads of 36,
  off the 16-byte loads) with R > K and a clock past R; a short cache whose
  slots take one block each; three slots over 48 blocks each.  The caches
  after the launch
  equal ``write_row_pe``'s bit for bit (each written row, and every other
  row, the rows past each clock among them, untouched); the output is
  within ``TOL`` of the largest magnitude of the reference's.
* ``decode_step_pe`` of a two-layer model launches the kernel once a layer
  in every layout and dtype (``_build.LAUNCHES['txl_decode_attn']``), and
  the wrapper raises on a dtype it does not take: no plain fallback.

No JAX here: the card's machine has none, and the suite's conftest imports
it, so on the card run ``python -m pytest --noconftest -m card
tests/test_torch_txl_decode_attn_card.py``; each test skips without one."""

import pytest
import torch

from emo_disentanger_tpu_torch.models.txl import PlainTransformer
from emo_disentanger_tpu_torch.ops import _build
from emo_disentanger_tpu_torch.ops import attention as attn
from emo_disentanger_tpu_torch.utils.precision import cast_params

# Of the largest magnitude of the float32 reference's output.  bf16: the
# kernel sums the same bf16 values in float32, so it differs from the
# reference by the order of its float32 sums (~1e-6) and by its output's
# rounding to bf16, a relative step of at most 2^-8 (3.9e-3).  f32: the
# order of the float32 sums over up to 1536 rows and the exponentials'
# last bits.
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
DTYPES = {'bf16': torch.bfloat16, 'f32': torch.float32}
LAYOUTS = ('khd', 'hkd', 'dk')
CELL = dict(b=256, k=1536, r=1536, h=8, dh=64)
SMALL = {'H6Dh48': dict(b=24, k=700, r=720, h=6, dh=48),
         'H4Dh36': dict(b=24, k=700, r=720, h=4, dh=36),
         'K32': dict(b=12, k=32, r=32, h=8, dh=64),
         'B3': dict(b=3, k=1536, r=1536, h=8, dh=64)}

pytestmark = pytest.mark.card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _clocks(b, k, r):
    """0, 1, 203, 499, K - 1, K + 5 and R + 3 in turn over the slots."""
    clocks = (0, 1, 203, 499, k - 1, k + 5, r + 3)
    return torch.tensor([clocks[i % len(clocks)] for i in range(b)])


def _inputs(layout, dtype, dev, *, b, k, r, h, dh, seed=0):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev, dtype)  # noqa: E731
    q, k_new, v_new = (x.reshape(b, h, dh)
                       for x in rnd(b, 3 * h * dh).chunk(3, -1))
    shape = {'khd': (b, k, h, dh), 'hkd': (b, h, k, dh), 'dk': (b, h, dh, k)}
    r_shape = (r, h, dh) if layout == 'khd' else (h, dh, r)
    return (q, k_new, v_new, rnd(*shape[layout]), rnd(*shape[layout]),
            _clocks(b, k, r).to(dev), rnd(*r_shape), 0.1 * rnd(h, dh),
            0.1 * rnd(h, dh))


def _check(layout, dtype, dev, dims):
    q, k_new, v_new, kc, vc, t, r, r_w, r_r = _inputs(layout, dtype, dev,
                                                      **dims)
    scale = dims['dh'] ** -0.5
    kw, vw = kc.clone(), vc.clone()
    attn.write_row_pe(kw, k_new, t, layout)
    attn.write_row_pe(vw, v_new, t, layout)
    f = lambda x: x.float()  # noqa: E731
    want = attn.full_decode_attention_pe(
        f(q) + f(r_w), f(kw), f(vw), t, scale=scale,
        rel=(f(q) + f(r_r), f(r)), layout=layout)
    n0 = _build.LAUNCHES['txl_decode_attn']
    got = attn._txl_decode_attention_cuda(q, k_new, v_new, kc, vc, t, r, r_w,
                                          r_r, scale=scale, layout=layout)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['txl_decode_attn'] == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(kc, kw) and torch.equal(vc, vw)
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert err <= TOL[dtype], err


@pytest.mark.parametrize('dtype', list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize('layout', LAYOUTS)
def test_cell_widths(layout, dtype, dev):
    _check(layout, DTYPES[dtype], dev, CELL)


@pytest.mark.parametrize('dims', list(SMALL), ids=list(SMALL))
@pytest.mark.parametrize('layout', LAYOUTS)
def test_other_shapes(layout, dims, dev):
    _check(layout, torch.bfloat16, dev, SMALL[dims])


@pytest.mark.parametrize('dtype', list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize('layout', LAYOUTS)
def test_decode_step_pe_launches_once_a_layer(layout, dtype, dev):
    g = torch.Generator().manual_seed(4)
    model = PlainTransformer(40, n_layer=2, n_head=8, d_model=512, d_ff=256,
                             d_embed=512, dropout=0.0, device=dev,
                             generator=g).eval()
    if dtype == 'bf16':
        cast_params(model)
    cache = model.init_decode_cache(4, 64, layout)
    t = torch.tensor([0, 3, 63, 70], device=dev)
    tok = torch.randint(0, 39, (4,), generator=g).to(dev)
    n0 = _build.LAUNCHES['txl_decode_attn']
    with torch.no_grad():
        logits, _ = model.decode_step_pe(tok, t, cache, layout)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['txl_decode_attn'] - n0 == model.n_layer
    assert bool(torch.isfinite(logits).all())


def test_refuses_float16(dev):
    args = _inputs('khd', torch.float16, dev, b=2, k=8, r=8, h=8, dh=64)
    n0 = _build.LAUNCHES['txl_decode_attn']
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        attn.txl_decode_attention_pe(*args, scale=0.125, layout='khd')
    assert _build.LAUNCHES['txl_decode_attn'] == n0
