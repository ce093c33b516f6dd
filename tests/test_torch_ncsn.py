"""NCSN score network of the port (audiosourcesep_tpu_torch/models/ncsn)
against audiosourcesep_tpu.models.ncsn, float32 on the CPU, with the
JAX-initialised weights carried over by params_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosourcesep_tpu.models.ncsn import RefineNetDilated as JRefineNet
from audiosourcesep_tpu.models.ncsn import get_sigmas as jget_sigmas
from audiosourcesep_tpu.models.ncsn.layers import _norm2dplus as j_norm2dplus
from audiosourcesep_tpu_torch import nn as tnn
from audiosourcesep_tpu_torch.models.ncsn import (RefineNetDilated,
                                                  get_score_model, get_sigmas)
from audiosourcesep_tpu_torch.models.ncsn.layers import _norm2dplus
from audiosourcesep_tpu_torch.ops import winograd as twino
from audiosourcesep_tpu_torch.training.checkpoint import params_from_jax

torch.set_num_threads(2)


def _flat_params(p):
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


def _port(jmodel, jparams, **kw):
    m = RefineNetDilated(jmodel.data_shape, jmodel.ngf,
                         num_classes=jmodel.num_classes,
                         sigmas=(None if jmodel.sigmas is None
                                 else np.asarray(jmodel.sigmas)), **kw)
    m.load_state_dict(params_from_jax(_flat_params(jparams)))
    return m.eval()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


class TestNorm2dPlus:
    def test_matches_jax(self):
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((3, 6, 5, 4)) * 2 + 0.5).astype(np.float32)
        rows = [rng.standard_normal((3, 4)).astype(np.float32)
                for _ in range(3)]
        want = np.asarray(j_norm2dplus(jnp.asarray(x),
                                       *map(jnp.asarray, rows)))
        got = _norm2dplus(_nchw(x), *map(torch.from_numpy, rows))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=2e-5)

    def test_one_pass_variance_no_nan_on_large_means(self):
        # per-channel constants of large magnitude: ~0 variance with heavy
        # cancellation in the one-pass E[x^2]-E[x]^2
        rng = np.random.default_rng(0)
        x = (np.array([1e4, -1e4, 3e4, 1.0], np.float32)[None, None, None]
             + 1e-2 * rng.standard_normal((2, 8, 8, 4))).astype(np.float32)
        ones, zeros = torch.ones(2, 4), torch.zeros(2, 4)
        out = _norm2dplus(_nchw(x), ones, ones, zeros)
        assert torch.isfinite(out).all()


class TestRefineNet:
    def test_v1_param_count_at_192_filters(self):
        # reference piano prior: 67,464,769 params; counted on the meta
        # device, so nothing is allocated and no forward runs
        m = RefineNetDilated((96, 64, 1), 192, num_classes=10, device="meta")
        assert m.count_params() == 67_464_769

    def test_state_dict_names_match_jax_params(self):
        jm = JRefineNet((16, 16, 1), 4, num_classes=2)
        jp = jm.init_params(jax.random.PRNGKey(0))
        m = RefineNetDilated((16, 16, 1), 4, num_classes=2, device="meta")
        assert set(m.state_dict()) == set(params_from_jax(_flat_params(jp)))

    # f32 forward parity: atol 2e-4 on scores of O(1) (measured ~1e-5;
    # the Winograd route adds its transform rounding)
    @pytest.mark.parametrize("winograd", [False, True])
    def test_v1_forward_matches_jax(self, winograd, monkeypatch):
        jm = JRefineNet((32, 16, 1), 8, num_classes=3)
        jp = jm.init_params(jax.random.PRNGKey(1))
        x = np.random.default_rng(2).uniform(size=(2, 32, 16, 1)).astype(
            np.float32)
        idx = np.array([0, 2], np.int32)
        want = np.asarray(jm.apply(jp, jnp.asarray(x), jnp.asarray(idx)))
        m = _port(jm, jp)
        routed = []
        real = twino.winograd_conv2d
        monkeypatch.setattr(twino, "winograd_conv2d",
                            lambda a, k: routed.append(1) or real(a, k))
        try:
            tnn.set_winograd(winograd)
            with torch.no_grad():
                got = m(torch.from_numpy(x), torch.from_numpy(idx).long())
        finally:
            tnn.set_winograd(False)
        assert got.shape == (2, 32, 16, 1) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)
        # 64 of the 75 convs are 3x3 undilated with even H, W
        assert len(routed) == (64 if winograd else 0)

    def test_v2_forward_matches_jax(self):
        sig = jget_sigmas(1.0, 0.1, 4)
        jm = JRefineNet((16, 16, 1), 4, sigmas=sig)
        jp = jm.init_params(jax.random.PRNGKey(3))
        x = np.random.default_rng(4).standard_normal((2, 16, 16, 1)).astype(
            np.float32)
        idx = np.array([1, 3], np.int32)
        want = np.asarray(jm.apply(jp, jnp.asarray(x), jnp.asarray(idx)))
        with torch.no_grad():
            got = _port(jm, jp)(torch.from_numpy(x),
                                torch.from_numpy(idx).long())
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)

    def test_bf16_compute_close_to_f32(self):
        m = get_score_model("v1", (16, 16, 1), 8, 4).reset_parameters(
            torch.Generator().manual_seed(0))
        m16 = get_score_model("v1", (16, 16, 1), 8, 4,
                              compute_dtype=torch.bfloat16)
        m16.load_state_dict(m.state_dict())
        x = torch.from_numpy(np.random.default_rng(5).uniform(
            size=(2, 16, 16, 1)).astype(np.float32))
        idx = torch.zeros(2, dtype=torch.long)
        with torch.no_grad():
            s32, s16 = m(x, idx), m16(x, idx)
        assert s16.dtype == torch.float32
        assert float((s16 - s32).abs().mean() / s32.abs().mean()) < 0.05


def test_get_sigmas_matches_jax():
    for prog in ("geometric", "logarithmic"):
        np.testing.assert_allclose(get_sigmas(1.0, 0.01, 10, prog),
                                   jget_sigmas(1.0, 0.01, 10, prog),
                                   rtol=1e-7)
