"""The port's FAVOR+ ops (plain PyTorch versions, CPU) against the JAX
package: feature maps, the fused attention forward (JAX's Pallas kernels in
interpret mode) and the decode step.  All f32 at the JAX suite's op
tolerance, rtol 2e-4 / atol 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emo_disentanger_tpu.ops import linear_attention as jla
from emo_disentanger_tpu_torch.ops import linear_attention as tla
from torch_port_helpers import ATOL, RTOL


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _omega(seed, d_head=8, m=16):
    return np.array(jla.draw_orthogonal_features(
        jax.random.PRNGKey(seed), d_head, m))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('is_query,key_stabilizer', [
    (True, None), (False, None), (False, 0.0)])
def test_favor_features_match_jax(is_query, key_stabilizer):
    rng = np.random.RandomState(0)
    x = _randn(rng, 2, 3, 20, 8, scale=0.7)
    om = _omega(1)
    want = jla.favor_features(jnp.asarray(x), jnp.asarray(om),
                              is_query=is_query, key_stabilizer=key_stabilizer)
    got = tla.favor_features(torch.from_numpy(x), torch.from_numpy(om),
                             is_query=is_query, key_stabilizer=key_stabilizer)
    _close(got, want)


def test_causal_linear_attention_ref_matches_jax():
    rng = np.random.RandomState(1)
    pq, pk = (rng.uniform(0.01, 1.0, (2, 3, 30, 16)).astype(np.float32)
              for _ in range(2))
    v = _randn(rng, 2, 3, 30, 8)
    want = jla.causal_linear_attention_ref(*map(jnp.asarray, (pq, pk, v)))
    got = tla.causal_linear_attention_ref(*map(torch.from_numpy, (pq, pk, v)))
    _close(got, want)


def test_favor_attention_matches_jax_fused_interpret(monkeypatch):
    """L=64 in chunks of 32 through the JAX Pallas kernels (_kmax_kernel and
    _fused_fwd_kernel, interpret mode; bh=4 is a valid group) against the
    port's plain chunked scan at the same chunk."""
    monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', '1')
    rng = np.random.RandomState(2)
    q, k, v = (_randn(rng, 2, 2, 64, 8, scale=0.7) for _ in range(3))
    om = _omega(3)
    assert jla._use_pallas()
    want = jla.favor_causal_attention(*map(jnp.asarray, (q, k, v, om)), 32)
    got = tla.favor_causal_attention(*map(torch.from_numpy, (q, k, v, om)), 32)
    assert got.dtype == torch.float32 and got.shape == (2, 2, 64, 8)
    _close(got, want)


def test_key_max_matches_jax_kmax_kernel_interpret(monkeypatch):
    """The plain version of the key-stabilizer kernel against JAX's
    _kmax_kernel in interpret mode: one max per batch*head row."""
    monkeypatch.setenv('EMODIS_PALLAS_INTERPRET', '1')
    rng = np.random.RandomState(7)
    k2 = _randn(rng, 4, 64, 8, scale=0.7)
    om = _omega(8)
    want = jla._fused_key_max(jnp.asarray(k2), jnp.asarray(om), 32, 8 ** -0.25)
    got = tla._key_max_plain(torch.from_numpy(k2), torch.from_numpy(om))
    assert got.shape == (4,)
    _close(got, np.asarray(want)[:, 0])


def test_favor_attention_odd_length_matches_jax_composed():
    """L=41 (a ragged last chunk) against the JAX composed path, which,
    like the port, takes the key stabilizer over the true L."""
    rng = np.random.RandomState(4)
    q, k, v = (_randn(rng, 2, 3, 41, 8, scale=0.7) for _ in range(3))
    om = _omega(5)
    want = jla.favor_causal_attention(*map(jnp.asarray, (q, k, v, om)), 16)
    got = tla.favor_causal_attention(*map(torch.from_numpy, (q, k, v, om)), 16)
    _close(got, want)
    # the port's chunk only reorders the sums
    _close(tla.favor_causal_attention(*map(torch.from_numpy, (q, k, v, om))),
           want)


@pytest.mark.parametrize('layout', ['dm', 'md'])
def test_decode_step_matches_jax(layout):
    """Three masked steps from a non-zero state in either layout."""
    rng = np.random.RandomState(6)
    B, H, M, Dv = 3, 2, 16, 8
    sshape = (B, H, Dv, M) if layout == 'dm' else (B, H, M, Dv)
    S = rng.uniform(0.0, 0.5, sshape).astype(np.float32)
    z = rng.uniform(0.0, 0.5, (B, H, M)).astype(np.float32)
    jS, jz, tS, tz = jnp.asarray(S), jnp.asarray(z), torch.from_numpy(S), torch.from_numpy(z)
    for step in range(3):
        pq, pk = (rng.uniform(0.01, 1.0, (B, H, M)).astype(np.float32)
                  for _ in range(2))
        v = _randn(rng, B, H, Dv)
        mask = rng.rand(B, 1) > 0.4
        jo, jS, jz = jla.linear_attention_decode_step(
            *map(jnp.asarray, (pq, pk, v)), jS, jz,
            update_mask=jnp.asarray(mask), state_layout=layout)
        to, tS, tz = tla.linear_attention_decode_step(
            *map(torch.from_numpy, (pq, pk, v)), tS, tz,
            update_mask=torch.from_numpy(mask), state_layout=layout)
        for got, want in ((to, jo), (tS, jS), (tz, jz)):
            _close(got, want)


def test_draw_orthogonal_features_blocks_are_orthogonal():
    """The port's own draw: [d_head, n_dims], each d_head-column block's
    directions orthonormal, on the generator's device."""
    om = tla.draw_orthogonal_features(8, 20, torch.Generator().manual_seed(0))
    assert om.shape == (8, 20) and om.dtype == torch.float32
    dirs = om / om.norm(dim=0, keepdim=True)
    for c0 in range(0, 20, 8):
        blk = dirs[:, c0:c0 + 8]
        np.testing.assert_allclose(blk.T @ blk, np.eye(blk.shape[1]),
                                   atol=1e-5)
