"""The wrappers of kernels #12, #13, the FAVOR+ key max (#1, #8), forward
(#2, #9) and the backward passes A (#3, #10) and B (#4, #11), and of the
composed op's forward (#5) and backward passes (#6, #7), refuse what their
kernels do not take, before anything is built or launched.

``_flash_attention_cuda``, ``_decode_layer_cuda``, the key max's
``_favor_kmax_cuda`` and ``_favor_kmax_hl_cuda``, the forward's
``_favor_fwd_cuda`` and ``_favor_fwd_hl_cuda`` and the backward passes'
``_favor_bwd_{a,b}_cuda`` and ``_favor_bwd_{a,b}_hl_cuda`` refuse CPU
tensors (the public entry points would run the plain versions there); then
each checks its inputs with a function (``_check_inputs``,
``_check_kmax_inputs``, ``_check_kmax_hl_inputs``,
``_check_fwd_inputs``, ``_check_fwd_hl_inputs``,
``_check_bwd_{a,b}_inputs``, ``_check_bwd_{a,b}_hl_inputs``) that is
called here on CPU tensors so that each bad dtype, shape or layout raises
its own error.
``_build.library`` is replaced by a stub that fails the test, so none of
these reaches nvcc or a launch."""

import collections
import types

import pytest
import torch

from emo_disentanger_tpu_torch.ops import _build
from emo_disentanger_tpu_torch.ops import flash_attention as fa
from emo_disentanger_tpu_torch.ops import linear_attention as la
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


def _pass_a(layout, Dh=64, Dv=64, M=32, dtype=torch.float32, B=2, n_head=2, L=80):
    """Pass A's inputs: q, k, v, g, omega, partial; head-major [B*H, L, D]
    or heads-last [B, L, H*D] (Dv = Dh)."""
    g = torch.Generator().manual_seed(2)
    if layout == 'heads-last':
        shape_x = shape_v = (B, L, n_head * Dh)
    else:
        shape_x, shape_v = (B * n_head, L, Dh), (B * n_head, L, Dv)
    q, k = [torch.randn(shape_x, generator=g).to(dtype) for _ in range(2)]
    v, dout = [torch.randn(shape_v, generator=g).to(dtype) for _ in range(2)]
    omega = torch.randn(Dh, M, generator=g)
    return q, k, v, dout, omega, torch.zeros(B * n_head, -(-L // la.KERNEL_CHUNK))


def _bwd_a_cases(layout):
    q, k, v, g, omega, part = args = _pass_a(layout)
    return {
        'cpu': (args, 'CUDA tensors'),
        'mixed dtypes': ((q, k.to(torch.bfloat16), v, g, omega, part), 'k has dtype'),
        'dtype of g': ((q, k, v, g.double(), omega, part), 'g has dtype'),
        'g of another shape': ((q, k, v, g[..., :-4].contiguous(), omega, part),
                               r': g \('),
        'head width under bf16': (_pass_a(layout, Dh=40, Dv=40, dtype=torch.bfloat16),
                                  'multiples of 16 under bf16'),
        'features under bf16': (_pass_a(layout, M=40, dtype=torch.bfloat16),
                                'multiples of 16 under bf16'),
        'misaligned under bf16': (_misaligned(_pass_a(layout, dtype=torch.bfloat16), 2),
                                  '16-byte boundary'),
    }


def _misaligned(args, i):
    """``args`` with its bf16 tensor ``i`` starting one element past a
    16-byte boundary."""
    t = args[i]
    shifted = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    return args[:i] + (shifted,) + args[i + 1:]


def _check_bwd_a(layout, *args):
    if layout == 'heads-last':
        return la._check_bwd_a_hl_inputs(*args, 2)
    return la._check_bwd_a_inputs(*args)


@pytest.mark.parametrize('case', sorted(_bwd_a_cases('head-major')))
@pytest.mark.parametrize('layout', ['head-major', 'heads-last'])
def test_favor_bwd_a_refuses(layout, case):
    args, match = _bwd_a_cases(layout)[case]
    with pytest.raises(ValueError, match=match):
        if case != 'cpu':
            _check_bwd_a(layout, *args)
        elif layout == 'heads-last':
            la._favor_bwd_a_hl_cuda(*args, 2)
        else:
            la._favor_bwd_a_cuda(*args)


@pytest.mark.parametrize('layout', ['head-major', 'heads-last'])
def test_favor_bwd_a_widths_in_f32(layout):
    """f32 keeps the multiple of 4 that bf16 refuses."""
    dims = _check_bwd_a(layout, *_pass_a(layout, Dh=40, Dv=40, M=36))
    assert dims == ((4, 80, 40, 40, 36) if layout == 'head-major' else (2, 80, 40, 36))
    assert _check_bwd_a(layout, *_pass_a(layout, dtype=torch.bfloat16))[-1] == 32


@pytest.mark.parametrize('tile, ok', [(4, True), (16, False)])
def test_check_bwd_shapes_width_rule(tile, ok):
    """``_check_favor_shapes`` (``_check_bwd_shapes`` before the forward
    shared it) takes Dh = Dv = 40 at the f32 multiple of 4 and refuses it
    at the bf16 multiple of 16 of the forward and both passes, naming the
    rule."""
    q, k, v, _, omega, part = _pass_a('head-major', Dh=40, Dv=40)
    for name in ('favor_fwd', 'favor_bwd_a', 'favor_bwd_b'):
        if ok:
            assert la._check_favor_shapes(name, q, k, v, omega, part, tile) == (
                4, 80, 40, 40, 32)
        else:
            with pytest.raises(ValueError, match=f'{name}: Dh=40, Dv=40 and M=32 '
                                                 'must be multiples of 16 under bf16'):
                la._check_favor_shapes(name, q, k, v, omega, part, tile)


def _pass_b(layout, **kw):
    """Pass B's inputs: q, k, v, u, w, omega, partial, with u of v's shape
    and w [B*H, L] in q's dtype."""
    q, k, v, u, omega, part = _pass_a(layout, **kw)
    w = torch.randn(part.shape[0], q.shape[1],
                    generator=torch.Generator().manual_seed(3)).to(q.dtype)
    return q, k, v, u, w, omega, part


def _bwd_b_cases(layout):
    q, k, v, u, w, omega, part = args = _pass_b(layout)
    return {
        'cpu': (args, 'CUDA tensors'),
        'dtype of u': ((q, k, v, u.to(torch.bfloat16), w, omega, part), 'u has dtype'),
        'dtype of w': ((q, k, v, u, w.double(), omega, part), 'w has dtype'),
        'w of another shape': ((q, k, v, u, w[:, :-1].contiguous(), omega, part),
                               r'w \('),
        'head width under bf16': (_pass_b(layout, Dh=40, Dv=40, dtype=torch.bfloat16),
                                  'multiples of 16 under bf16'),
        'features under bf16': (_pass_b(layout, M=40, dtype=torch.bfloat16),
                                'multiples of 16 under bf16'),
        'misaligned u under bf16': (_misaligned(_pass_b(layout, dtype=torch.bfloat16), 3),
                                    'bf16 u must start on a 16-byte boundary'),
    }


def _check_bwd_b(layout, *args):
    if layout == 'heads-last':
        return la._check_bwd_b_hl_inputs(*args, 2)
    return la._check_bwd_b_inputs(*args)


@pytest.mark.parametrize('case', sorted(_bwd_b_cases('head-major')))
@pytest.mark.parametrize('layout', ['head-major', 'heads-last'])
def test_favor_bwd_b_refuses(layout, case):
    args, match = _bwd_b_cases(layout)[case]
    with pytest.raises(ValueError, match=match):
        if case != 'cpu':
            _check_bwd_b(layout, *args)
        elif layout == 'heads-last':
            la._favor_bwd_b_hl_cuda(*args, 2)
        else:
            la._favor_bwd_b_cuda(*args)


@pytest.mark.parametrize('layout', ['head-major', 'heads-last'])
def test_favor_bwd_b_widths_in_f32(layout):
    """f32 keeps the multiple of 4 that bf16 refuses; bf16 takes the
    multiple of 16 on aligned inputs."""
    dims = _check_bwd_b(layout, *_pass_b(layout, Dh=40, Dv=40, M=36))
    assert dims == ((4, 80, 40, 40, 36) if layout == 'head-major' else (2, 80, 40, 36))
    assert _check_bwd_b(layout, *_pass_b(layout, dtype=torch.bfloat16))[-1] == 32


def _fwd(layout, **kw):
    """The forward's inputs: q, k, v, omega, partial (pass A's without g)."""
    q, k, v, _, omega, part = _pass_a(layout, **kw)
    return q, k, v, omega, part


def _fwd_cases(layout):
    q, k, v, omega, part = args = _fwd(layout)
    return {
        'cpu': (args, 'CUDA tensors'),
        'mixed dtypes': ((q, k, v.to(torch.bfloat16), omega, part), 'v has dtype'),
        'dtype of omega': ((q, k, v, omega.double(), part), 'omega has dtype'),
        'partial of another length': ((q, k, v, omega, part[:, :1].contiguous()),
                                      r'partial \('),
        'head width under bf16': (_fwd(layout, Dh=40, Dv=40, dtype=torch.bfloat16),
                                  'multiples of 16 under bf16'),
        'features under bf16': (_fwd(layout, M=40, dtype=torch.bfloat16),
                                'multiples of 16 under bf16'),
        'misaligned q under bf16': (_misaligned(_fwd(layout, dtype=torch.bfloat16), 0),
                                    'bf16 q must start on a 16-byte boundary'),
        'misaligned k under bf16': (_misaligned(_fwd(layout, dtype=torch.bfloat16), 1),
                                    'bf16 k must start on a 16-byte boundary'),
        'misaligned v under bf16': (_misaligned(_fwd(layout, dtype=torch.bfloat16), 2),
                                    'bf16 v must start on a 16-byte boundary'),
    }


def _check_fwd(layout, *args):
    if layout == 'heads-last':
        return la._check_fwd_hl_inputs(*args, 2)
    return la._check_fwd_inputs(*args)


@pytest.mark.parametrize('case', sorted(_fwd_cases('head-major')))
@pytest.mark.parametrize('layout', ['head-major', 'heads-last'])
def test_favor_fwd_refuses(layout, case):
    args, match = _fwd_cases(layout)[case]
    with pytest.raises(ValueError, match=match):
        if case != 'cpu':
            _check_fwd(layout, *args)
        elif layout == 'heads-last':
            la._favor_fwd_hl_cuda(*args, 2)
        else:
            la._favor_fwd_cuda(*args)


@pytest.mark.parametrize('layout', ['head-major', 'heads-last'])
def test_favor_fwd_widths_in_f32(layout):
    """f32 keeps the multiple of 4 that bf16 refuses; bf16 takes the
    multiple of 16 on aligned inputs."""
    dims = _check_fwd(layout, *_fwd(layout, Dh=40, Dv=40, M=36))
    assert dims == ((4, 80, 40, 40, 36) if layout == 'head-major' else (2, 80, 40, 36))
    assert _check_fwd(layout, *_fwd(layout, dtype=torch.bfloat16))[-1] == 32


def _kmax(layout, **kw):
    """The key max's inputs: k, omega (pass A's)."""
    _, k, _, _, omega, _ = _pass_a(layout, **kw)
    return k, omega


def _kmax_cases(layout):
    k, omega = args = _kmax(layout)
    bf = torch.bfloat16
    return {
        'cpu': (args, 'CUDA tensors'),
        'dtype of k': ((k.double(), omega), 'k has dtype'),
        'dtype of omega': ((k, omega.double()), 'omega has dtype'),
        'omega of another width': ((k, omega[:-1].contiguous()), r'omega \('),
        'head width under bf16': (_kmax(layout, Dh=40, dtype=bf),
                                  'multiples of 16 under bf16'),
        'features under bf16': (_kmax(layout, M=40, dtype=bf),
                                'multiples of 16 under bf16'),
        'features in f32': (_kmax(layout, M=38), 'of 4'),
        'misaligned k under bf16': (_misaligned(_kmax(layout, dtype=bf), 0),
                                    'bf16 k must start on a 16-byte boundary'),
    }


def _check_kmax(layout, *args):
    if layout == 'heads-last':
        return la._check_kmax_hl_inputs(*args, 2)
    return la._check_kmax_inputs(*args)


@pytest.mark.parametrize('case', sorted(_kmax_cases('head-major')))
@pytest.mark.parametrize('layout', ['head-major', 'heads-last'])
def test_favor_kmax_refuses(layout, case):
    args, match = _kmax_cases(layout)[case]
    with pytest.raises(ValueError, match=match):
        if case != 'cpu':
            _check_kmax(layout, *args)
        elif layout == 'heads-last':
            la._favor_kmax_hl_cuda(*args, 2)
        else:
            la._favor_kmax_cuda(*args)


@pytest.mark.parametrize('layout', ['head-major', 'heads-last'])
def test_favor_kmax_widths_in_f32(layout):
    """f32 keeps its rule, M a multiple of 4 (heads-last, Dh too), so the
    widths that bf16 refuses pass; bf16 takes multiples of 16 on aligned
    k."""
    dims = _check_kmax(layout, *_kmax(layout, Dh=40, M=36))
    assert dims == ((4, 80, 40, 36) if layout == 'head-major' else (2, 80, 40, 36))
    if layout == 'head-major':
        assert _check_kmax(layout, *_kmax(layout, Dh=42, M=36)) == (4, 80, 42, 36)
    assert _check_kmax(layout, *_kmax(layout, dtype=torch.bfloat16)) == (
        (4, 80, 64, 32) if layout == 'head-major' else (2, 80, 64, 32))


@pytest.mark.parametrize('L', [64, 80, 1000])
@pytest.mark.parametrize('layout', ['head-major', 'heads-last'])
def test_favor_kmax_partial_shape(monkeypatch, layout, L):
    """The wrappers give the kernel a partial [BH, ceil(L/64)] f32 on k's
    device, one max per 64-row chunk, which the forward's check takes.  The
    library, the device check and the stream are faked, so nothing is built
    or launched; the launch count is restored with the rest."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0
    monkeypatch.setattr(la, '_lib', Lib)
    monkeypatch.setattr(la, '_require_cuda', lambda device: None)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, 'LAUNCHES', collections.Counter())
    q, k, v, omega, _ = _fwd(layout, L=L, dtype=torch.bfloat16)
    if layout == 'heads-last':
        part, name = la._favor_kmax_hl_cuda(k, omega, 2), 'favor_kmax_hl'
    else:
        part, name = la._favor_kmax_cuda(k, omega), 'favor_kmax'
    assert part.shape == (4, -(-L // 64)) and part.dtype == torch.float32
    assert [(n, args[2]) for n, args in calls] == [(name, part.data_ptr())]
    assert _build.LAUNCHES == {name: 1}
    assert _check_fwd(layout, q, k, v, omega, part)[1] == L
    monkeypatch.undo()


# the composed op's backward passes (#6 cla_bwd_a, #7 cla_bwd_b): f32, M and
# Dv multiples of 4 (padded to 16 in shared memory), rows loaded 16 bytes at
# a time; the library, the device check and the stream faked as above


def _cla(M=36, Dv=20, BH=3, L=70, dtype=torch.float32):
    """phi_q, phi_k [BH, L, M], v, g [BH, L, Dv]."""
    gen = torch.Generator().manual_seed(5)
    q, k = (torch.rand(BH, L, M, generator=gen).to(dtype) for _ in range(2))
    v, g = (torch.randn(BH, L, Dv, generator=gen).to(dtype) for _ in range(2))
    return q, k, v, g


def _fake_cla_lib(monkeypatch):
    """Fake the library, the device check and the stream; returns the list
    the fake library appends (name, args) to, each launch returning 0."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0
    monkeypatch.setattr(la, '_cla_lib', Lib)
    monkeypatch.setattr(la, '_require_cuda', lambda device: None)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, 'LAUNCHES', collections.Counter())
    return calls


def _cla_pass(name, q, k, v, g):
    """Launch pass ``name`` ('a' or 'b'; b takes g as u and a w of its own)."""
    if name == 'a':
        return la._cla_bwd_a_cuda(q, k, v, g)
    w = torch.zeros(q.shape[:2], dtype=q.dtype)
    return la._cla_bwd_b_cuda(q, k, v, g, w)


@pytest.mark.parametrize('name', ['a', 'b'])
def test_cla_bwd_takes_widths_off_16(monkeypatch, name):
    """M, Dv = 36, 20 (multiples of 4, not of 16) reach the kernel with
    their own widths, outputs f32 of the inputs' shapes and w [BH, L]."""
    calls = _fake_cla_lib(monkeypatch)
    q, k, v, g = _cla()
    outs = _cla_pass(name, q, k, v, g)
    (kernel, args), = calls
    assert kernel == f'cla_bwd_{name}' and _build.LAUNCHES == {kernel: 1}
    first = 7
    assert args[first:first + 4] == (3, 70, 36, 20)
    shapes = ([(3, 70, 36), (3, 70, 20), (3, 70)] if name == 'a'
              else [(3, 70, 36), (3, 70, 20)])
    assert [tuple(t.shape) for t in outs] == shapes
    assert all(t.dtype == torch.float32 for t in outs)
    out_ptrs = args[4:7] if name == 'a' else args[5:7]
    assert list(out_ptrs) == [t.data_ptr() for t in outs]
    monkeypatch.undo()


def _misaligned_f32(t):
    shifted = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    return shifted


def _cla_bad_cases():
    q, k, v, g = _cla()
    return {
        'M not a multiple of 4': (_cla(M=34), 'multiples of 4'),
        'bf16 inputs': (_cla(dtype=torch.bfloat16), 'phi_q has dtype'),
        'misaligned phi_q': ((_misaligned_f32(q), k, v, g),
                             'f32 phi_q must start on a 16-byte boundary'),
        'misaligned g or u': ((q, k, v, _misaligned_f32(g)), 'must start on a 16-byte boundary'),
    }


@pytest.mark.parametrize('case', sorted(_cla_bad_cases()))
@pytest.mark.parametrize('name', ['a', 'b'])
def test_cla_bwd_refuses(monkeypatch, name, case):
    """M = 34, bf16 inputs and an f32 input off a 16-byte boundary raise
    before the launch."""
    calls = _fake_cla_lib(monkeypatch)
    args, match = _cla_bad_cases()[case]
    with pytest.raises(ValueError, match=match):
        _cla_pass(name, *args)
    assert calls == [] and not _build.LAUNCHES
    monkeypatch.undo()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cla_backward_hands_the_kernels_aligned_f32_copies(monkeypatch, dtype):
    """``_cla_bwd_cuda``, the backward's CUDA branch, casts to f32 and
    copies a misaligned input again, so both passes launch on 16-byte
    aligned f32 tensors holding the same values; pass B gets pass A's u
    and a w of shape [BH, L]."""
    calls = _fake_cla_lib(monkeypatch)
    q, k, v, g = _cla()
    ins = [_misaligned_f32(t) if dtype == torch.float32 else t.to(dtype)
           for t in (q, k, v, g)]
    for t in ins:
        copy = la._f32_aligned(t)
        assert copy.data_ptr() % 16 == 0 and torch.equal(copy, t.float())
    dq, dk, dv = la._cla_bwd_cuda(*ins)
    (name_a, args_a), (name_b, args_b) = calls
    assert (name_a, name_b) == ('cla_bwd_a', 'cla_bwd_b')
    assert all(p % 16 == 0 for p in args_a[:4] + args_b[:5])
    assert args_b[3:5] == args_a[5:7]                 # pass A's u and w
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert all(t.dtype == torch.float32 for t in (dq, dk, dv))
    assert _build.LAUNCHES == {'cla_bwd_a': 1, 'cla_bwd_b': 1}
    monkeypatch.undo()


def test_cla_backward_of_a_device_tensor_never_runs_the_plain_passes(monkeypatch):
    """A tensor off the CPU takes ``_cla_bwd_cuda`` (here on the meta
    device, recorded) and never ``_cla_bwd_a_plain`` / ``_cla_bwd_b_plain``."""
    def plain(*args, **kwargs):
        raise AssertionError('a device tensor reached a plain pass')
    seen = []

    def cuda(q2, k2, v2, g, eps):
        seen.append((q2, k2, v2, g, eps))
        return q2.float(), k2.float(), v2.float()
    monkeypatch.setattr(la, '_cla_bwd_a_plain', plain)
    monkeypatch.setattr(la, '_cla_bwd_b_plain', plain)
    monkeypatch.setattr(la, '_cla_bwd_cuda', cuda)
    q, k, v, g = (t.to('meta') for t in _cla())
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v), chunk=64, eps=la.EPS)
    grads = la._CausalLinearAttention.backward(ctx, g)
    assert len(seen) == 1 and seen[0][3] is g and seen[0][4] == la.EPS
    assert [t.shape for t in grads[:3]] == [q.shape, k.shape, v.shape]
    monkeypatch.undo()


# the composed op's forward (#5 cla_fwd): each input f32 or bf16 on its own,
# M and Dv multiples of 4 (padded to 16 in shared memory), rows loaded four
# values at a time in the input's own type, so an f32 base on 16 bytes and
# a bf16 base on 8

FWD_DTYPES = {'f32': (torch.float32,) * 3, 'bf16': (torch.bfloat16,) * 3,
              'f32 features, bf16 v': (torch.float32, torch.float32, torch.bfloat16),
              'bf16 phi_q alone': (torch.bfloat16, torch.float32, torch.float32)}


def _cla_fwd_inputs(dtypes, M=36, Dv=20):
    return tuple(t.to(dt) for t, dt in zip(_cla(M, Dv)[:3], dtypes))


def _shifted(t, elements):
    """A contiguous copy of ``t`` starting ``elements`` values past a
    16-byte boundary."""
    base = torch.empty(t.numel() + 16, dtype=t.dtype)
    start = (-base.data_ptr() % 16) // t.element_size() + elements
    out = base[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == elements * t.element_size()
    return out


@pytest.mark.parametrize('mix', sorted(FWD_DTYPES))
def test_cla_fwd_takes_widths_off_16_in_each_dtype(monkeypatch, mix):
    """M, Dv = 36, 20 reach the forward in every mix of f32 and bf16, with
    each input's dtype flag, and out f32 [BH, L, Dv]."""
    calls = _fake_cla_lib(monkeypatch)
    q, k, v = _cla_fwd_inputs(FWD_DTYPES[mix])
    out = la._cla_fwd_cuda(q, k, v)
    (kernel, args), = calls
    assert kernel == 'cla_fwd' and _build.LAUNCHES == {'cla_fwd': 1}
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    assert args[4:8] == (3, 70, 36, 20)
    assert args[8:11] == tuple(int(t.dtype == torch.bfloat16) for t in (q, k, v))
    assert out.dtype == torch.float32 and tuple(out.shape) == (3, 70, 20)
    monkeypatch.undo()


def test_cla_fwd_takes_a_bf16_base_on_8_bytes(monkeypatch):
    """A bf16 input 8 bytes past a 16-byte boundary is on the boundary its
    8-byte loads need, and launches as it is."""
    calls = _fake_cla_lib(monkeypatch)
    q, k, v = (_shifted(t, 4) for t in _cla_fwd_inputs(FWD_DTYPES['bf16']))
    la._cla_fwd_cuda(q, k, v)
    (kernel, args), = calls
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    monkeypatch.undo()


def _cla_fwd_bad_cases():
    q, k, v = _cla_fwd_inputs(FWD_DTYPES['f32'])
    qb, kb, vb = _cla_fwd_inputs(FWD_DTYPES['bf16'])
    return {
        'M not a multiple of 4': (_cla_fwd_inputs(FWD_DTYPES['f32'], M=34),
                                  'multiples of 4'),
        'M not a multiple of 4 under bf16': (_cla_fwd_inputs(FWD_DTYPES['bf16'], M=34),
                                             'multiples of 4'),
        'float64': ((q.double(), k, v), 'phi_q has dtype'),
        'misaligned f32 phi_q': ((_shifted(q, 2), k, v),
                                 'f32 phi_q must start on a 16-byte boundary'),
        'misaligned f32 v': ((q, k, _shifted(v, 1)), 'f32 v must start on a 16-byte boundary'),
        'misaligned bf16 phi_k': ((qb, _shifted(kb, 1), vb),
                                  'bf16 phi_k must start on an? 8-byte boundary'),
        'misaligned bf16 v beside f32 features': ((q, k, _shifted(vb, 2)),
                                                  'bf16 v must start on an? 8-byte boundary'),
    }


@pytest.mark.parametrize('case', sorted(_cla_fwd_bad_cases()))
def test_cla_fwd_refuses(monkeypatch, case):
    """M = 34 (in either dtype), float64, an f32 input off 16 bytes and a
    bf16 input off 8 raise before the launch."""
    calls = _fake_cla_lib(monkeypatch)
    args, match = _cla_fwd_bad_cases()[case]
    with pytest.raises(ValueError, match=match):
        la._cla_fwd_cuda(*args)
    assert calls == [] and not _build.LAUNCHES
    monkeypatch.undo()


@pytest.mark.parametrize('mix', sorted(FWD_DTYPES))
def test_cla_forward_hands_the_kernel_aligned_copies_in_their_dtype(monkeypatch, mix):
    """``_cla_fwd_aligned_cuda``, the forward's CUDA branch, copies a
    misaligned input again in its own dtype (no cast: the kernel reads
    bf16) and leaves an aligned one as it is, so the forward launches on
    the same values and dtypes."""
    calls = _fake_cla_lib(monkeypatch)
    ins = _cla_fwd_inputs(FWD_DTYPES[mix])
    views = [_shifted(ins[0], 1), ins[1], _shifted(ins[2], 3)]
    for t in views:
        copy = la._aligned(t, la._CLA_FWD_ALIGN)
        assert copy.dtype == t.dtype and torch.equal(copy, t)
        assert copy.data_ptr() % (16 if t.dtype == torch.float32 else 8) == 0
    assert la._aligned(views[1], la._CLA_FWD_ALIGN) is views[1]
    out = la._cla_fwd_aligned_cuda(*views)
    (kernel, args), = calls
    assert kernel == 'cla_fwd' and _build.LAUNCHES == {'cla_fwd': 1}
    assert args[1] == views[1].data_ptr()
    assert args[0] != views[0].data_ptr() and args[2] != views[2].data_ptr()
    assert all(p % (16 if t.dtype == torch.float32 else 8) == 0
               for p, t in zip(args[:3], views))
    assert args[8:11] == tuple(int(t.dtype == torch.bfloat16) for t in views)
    assert out.dtype == torch.float32 and out.shape == views[2].shape
    monkeypatch.undo()


def test_cla_forward_of_a_device_tensor_never_runs_the_plain_version(monkeypatch):
    """A tensor off the CPU takes ``_cla_fwd_aligned_cuda`` (here on the
    meta device, recorded) and never ``_cla_fwd_plain``."""
    def plain(*args, **kwargs):
        raise AssertionError('a device tensor reached the plain forward')
    seen = []

    def cuda(q2, k2, v2, eps):
        seen.append((q2, k2, v2, eps))
        return torch.empty(v2.shape, dtype=torch.float32, device=v2.device)
    monkeypatch.setattr(la, '_cla_fwd_plain', plain)
    monkeypatch.setattr(la, '_cla_fwd_aligned_cuda', cuda)
    q, k, v = (t.to('meta') for t in _cla_fwd_inputs(FWD_DTYPES['f32 features, bf16 v']))
    out = la.causal_linear_attention(q, k, v)
    assert len(seen) == 1 and seen[0][3] == la.EPS
    assert seen[0][2].dtype == torch.bfloat16
    assert out.shape == v.shape and out.device.type == 'meta'
    monkeypatch.undo()
