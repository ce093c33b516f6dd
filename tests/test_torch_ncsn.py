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
from audiosourcesep_tpu_torch.models.ncsn import layers as tlayers
from audiosourcesep_tpu_torch.models.ncsn.layers import _norm2dplus
from audiosourcesep_tpu_torch.ops import counting
from audiosourcesep_tpu_torch.ops import instnorm as tinorm
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


class TestNormDispatch:
    """Which InstanceNorm++ runs: the CUDA kernel for a CUDA tensor, its
    forward under autograd too (the backward is the composite's VJP), and
    the composite for a CPU tensor, uncounted."""

    def test_act_runs_after_the_composite(self):
        rng = np.random.default_rng(1)
        x = _nchw((rng.standard_normal((3, 6, 5, 4)) * 2 + 0.5).astype(
            np.float32))
        rows = [torch.from_numpy(rng.standard_normal((3, 4)).astype(
            np.float32)) for _ in range(3)]
        got = _norm2dplus(x, *rows, act=tnn.elu)
        assert torch.equal(got, torch.nn.functional.elu(_norm2dplus(x,
                                                                   *rows)))

    @pytest.mark.parametrize("version", ["v1", "v2"])
    def test_cpu_forward_takes_the_composite_and_counts_nothing(self,
                                                               version):
        m = get_score_model(version, (16, 16, 1), 8, 4,
                            sigmas=get_sigmas(1.0, 0.1, 4)).reset_parameters(
            torch.Generator().manual_seed(0))
        x = torch.rand(2, 16, 16, 1, generator=torch.Generator()
                       .manual_seed(1))
        idx = torch.tensor([0, 3])
        before = counting.snapshot()
        with torch.no_grad():
            m(x, idx)
        m(x, idx).sum().backward()               # and under autograd
        assert counting.snapshot() == before

    def test_autograd_on_a_cuda_tensor_takes_the_composite_counted(self,
                                                                monkeypatch):
        """Under autograd the kernel still runs the forward (counted) and
        the composite's VJP the backward: here a stand-in for the kernel
        (the composite, counted as a launch) on CPU tensors, and the
        gradients in x and every table are the composite's own, bit for
        bit, for v1 and v2 rows, with and without the fused ELU."""
        def kernel(x, labels, *tables):
            counting.add({"instnorm": {"launch_count": 1}})
            *tables, elu = tables
            return tinorm.composite(x, labels, *tables,
                                    act=torch.nn.functional.elu if elu
                                    else None)

        monkeypatch.setattr(tinorm, "_instnorm_cuda", kernel)
        g = torch.Generator().manual_seed(4)
        x = torch.randn(3, 5, 4, 6, generator=g) * 2 + 1
        gy = torch.randn(3, 5, 4, 6, generator=g)
        for labels, k in ((torch.tensor([1, 0, 1]), (2,)), (None, ())):
            tables = [0.5 * torch.randn(*k, 5, generator=g)
                      for _ in range(3)]
            tables += [1 + 0.1 * torch.randn(5, generator=g),
                       0.1 * torch.randn(5, generator=g)]
            for elu in (False, True):
                leaves = [[t.clone().requires_grad_(True)
                           for t in (x, *tables)] for _ in range(2)]
                before = counting.snapshot()
                tinorm.instnorm_plus(leaves[0][0], labels, *leaves[0][1:],
                                     elu=elu).backward(gy)
                assert counting.since(before)["instnorm"] == {
                    "launch_count": 1, "layout_copies": 0}
                tinorm.composite(leaves[1][0], labels, *leaves[1][1:],
                                 act=torch.nn.functional.elu if elu
                                 else None).backward(gy)
                for got, want in zip(*leaves):
                    assert torch.equal(got.grad, want.grad)
                counting.add(counting.since(before), -1)

    @pytest.mark.parametrize("labels", [True, False])
    def test_composite_folds_the_rows_as_the_norm_modules_did(self, labels):
        """``composite`` gathers (v1) or tiles (v2) the tables' rows and
        folds them as the norm modules did before it, bit for bit."""
        g = torch.Generator().manual_seed(6)
        x = torch.randn(3, 7, 5, 4, generator=g) * 3 - 1
        k = (4,) if labels else ()
        gamma, alpha, beta = (torch.randn(*k, 7, generator=g)
                              for _ in range(3))
        in_gamma, in_beta = (torch.randn(7, generator=g) for _ in range(2))
        if labels:
            y = torch.tensor([3, 0, 3])
            rows = gamma[y]
            want = _norm2dplus(x, rows * in_gamma, alpha[y],
                               rows * in_beta + beta[y])
        else:
            y = None
            tile = lambda r: r[None, :].expand(3, 7)     # noqa: E731
            want = _norm2dplus(x, tile(gamma * in_gamma), tile(alpha),
                               tile(gamma * in_beta + beta))
        got = tinorm.composite(x, y, gamma, alpha, beta, in_gamma, in_beta)
        assert torch.equal(got, want)

    def test_the_kernel_refuses_a_cpu_tensor(self):
        ones = torch.ones(4)
        with pytest.raises(ValueError, match="CUDA"):
            tinorm._instnorm_cuda(torch.ones(2, 4, 3, 3), None, ones, ones,
                                  None, ones, ones)

    @pytest.mark.parametrize("version", ["v1", "v2"])
    def test_fused_act_forward_equals_the_old_composition(self, version,
                                                          monkeypatch):
        """The ResidualBlocks' and the final normalizer's ELU, now passed
        into the norm (``act=``), give on the CPU what ``act(norm(x))``
        gave, bit for bit."""
        m = get_score_model(version, (32, 16, 1), 8, 3,
                            sigmas=get_sigmas(1.0, 0.1, 3)).reset_parameters(
            torch.Generator().manual_seed(2))
        x = torch.rand(2, 32, 16, 1, generator=torch.Generator()
                       .manual_seed(3))
        idx = torch.tensor([2, 0])
        with torch.no_grad():
            fused = m(x, idx)
        acts = []
        for cls in (tlayers.InstanceNorm2dPlus,
                    tlayers.ConditionalInstanceNorm2dPlus):
            def old(self, x, y=None, act=None, _forward=cls.forward):
                acts.append(act)
                out = _forward(self, x, y)
                return out if act is None else act(out)
            monkeypatch.setattr(cls, "forward", old)
        with torch.no_grad():
            composed = m(x, idx)
        # 71 norms a v1 forward, 17 with the ELU passed in; v2's 17 norms
        # (its RCU, MSF and CRP blocks have none) all with the ELU
        assert len(acts) == (71 if version == "v1" else 17)
        assert sum(a is tnn.elu for a in acts) == 17
        assert torch.equal(fused, composed)

    def test_kernel_limits_are_the_cuda_sources(self):
        """The wrapper's copies of csrc/instnorm_plus.cu's limits."""
        import pathlib
        src = (pathlib.Path(tinorm.__file__).parent.parent / "csrc" /
               "instnorm_plus.cu").read_text()
        for name, value in (("VEC", tinorm.VEC), ("BLOCK", tinorm.BLOCK),
                            ("MAXC", tinorm.MAX_C)):
            assert f"constexpr int {name} = {value};" in src, name
        assert f"N > {tinorm.MAX_N}" in src
        assert f'int {tinorm.ENTRY}(' in src

    @pytest.mark.parametrize("shape,want", [
        # the cell's classes at batch 30 where the card holds 528 blocks
        # (132 SMs x 4): 17 slices, 510 blocks in one wave; a small batch
        # takes more slices, a small grid fewer (two pixels a thread)
        ((30, 192, 96 * 64), 17), ((30, 384, 48 * 32), 17),
        ((30, 192, 48 * 32), 17), ((4, 256, 12 * 8), 6),
        ((1, 16, 4 * 4), 1), ((2, 3, 5 * 7), 1), ((1, 4096, 9), 5),
        ((600, 192, 96 * 64), 1)])
    def test_slices(self, shape, want):
        n, c, hw = shape
        got = tinorm.slices(n, c, hw, 528)
        assert got == want and 1 <= got <= hw
        assert n * got <= max(528, n)


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
