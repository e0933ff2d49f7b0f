"""The wrappers of kernels #12 and #13 refuse what their kernels do not
take, before anything is built or launched.

``_flash_attention_cuda`` and ``_decode_layer_cuda`` refuse CPU tensors
(the public entry points would run the plain versions there); then each
checks its inputs with ``_check_inputs``, which is called here on CPU
tensors so that each bad dtype, shape or layout raises its own error.
``_build.library`` is replaced by a stub that fails the test, so none of
these reaches nvcc or a launch."""

import pytest
import torch

from emo_disentanger_tpu_torch.ops import _build
from emo_disentanger_tpu_torch.ops import flash_attention as fa
from emo_disentanger_tpu_torch.ops import performer_decode as pd


@pytest.fixture(autouse=True)
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('a wrapper reached the kernel library')
    monkeypatch.setattr(_build, 'library', refuse)
    launches = dict(_build.LAUNCHES)
    yield
    assert dict(_build.LAUNCHES) == launches


def _qkv(B=1, H=2, L=128, Dh=64, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(B, H, L, Dh, generator=g).to(dtype) for _ in range(3)]


def _flash_cases():
    q, k, v = _qkv()
    return {
        'cpu': ((q, k, v), 'CUDA tensors'),
        'dtype': ((q.double(), k, v), 'float32'),
        'dtype of v': ((q, k, v.to(torch.bfloat16)), 'v:'),
        'head width': (_qkv(Dh=32), 'Dh=64'),
        'length': (_qkv(L=192), 'multiple of 128'),
        'rank': ((q[0], k[0], v[0]), 'float32'),
        'shapes differ': ((q, k[:, :1], v), 'k:'),
        'non-contiguous': ((q, k.transpose(2, 3).contiguous().transpose(2, 3), v),
                           'contiguous=False'),
    }


@pytest.mark.parametrize('case', sorted(_flash_cases()))
def test_flash_attention_refuses(case):
    args, match = _flash_cases()[case]
    with pytest.raises(ValueError, match=match):
        if case == 'cpu':
            fa._flash_attention_cuda(*args, 0.125)
        else:
            fa._check_inputs(*args)


D, H, F, M = 128, 2, 128, 32


def _layer(dtype=torch.float32, B=3):
    g = torch.Generator().manual_seed(1)
    shapes = {'wq': (D, D), 'wk': (D, D), 'wv': (D, D), 'wo': (D, D),
              'w1': (F, D), 'w2': (D, F), 'b1': (F,)}
    p = {key: (0.05 * torch.randn(shapes.get(key, (D,)), generator=g)).to(dtype)
         for key in pd.PARAM_KEYS}
    x = torch.randn(B, D, generator=g).to(dtype)
    S = torch.zeros(B, H, D // H, M)
    z = torch.zeros(B, H, M)
    omega = torch.randn(D // H, M, generator=g)
    return x, S, z, p, omega, torch.ones(B)


def _decode_cases():
    x, S, z, p, omega, mask = _layer()
    bad_w = dict(p, wo=p['wo'].double())
    t_w = dict(p, w1=p['w2'].t())
    return {
        'cpu': ((x, S, z, p, omega, mask), 'CUDA tensors'),
        'dtype of x': ((x.double(), S, z, p, omega, mask), 'x must'),
        'dtype of a weight': ((x, S, z, bad_w, omega, mask), 'param wo'),
        'weights f64': ((x, S, z, {k: t.double() for k, t in p.items()}, omega, mask),
                        'weights must'),
        'shape of S': ((x, S[:, :, :-1], z, p, omega, mask), 'S:'),
        'dtype of z': ((x, S, z.double(), p, omega, mask), 'z:'),
        'shape of omega': ((x, S, z, p, omega[:-1], mask), 'omega:'),
        'mask shape': ((x, S, z, p, omega, mask[:-1]), 'update_mask'),
        'non-contiguous x': ((x.t().contiguous().t(), S, z, p, omega, mask), 'x must'),
        'non-contiguous weight': ((x, S, z, t_w, omega, mask), 'param w1'),
        'width': (_layer_narrow(), 'unsupported'),
    }


def _layer_narrow():
    x, S, z, p, omega, mask = _layer()
    return (x[:, :64].contiguous(), S, z, p, omega, mask)


@pytest.mark.parametrize('case', sorted(_decode_cases()))
def test_decode_layer_refuses(case):
    args, match = _decode_cases()[case]
    with pytest.raises(ValueError, match=match):
        if case == 'cpu':
            pd._decode_layer_cuda(*args, H)
        else:
            pd._check_inputs(*args, H)


def test_good_inputs_pass_the_checks():
    assert fa._check_inputs(*_qkv()) == (1, 2, 128, 64)
    dims, wdt, ptrs, mask = pd._check_inputs(*_layer(), H)
    assert dims == (3, D, H, M, F) and wdt == torch.float32
    assert len(ptrs) == len(pd.PARAM_KEYS) and mask.dtype == torch.float32
