"""The plain references against the port on the CPU at small widths, in
float32: the same parameter names and shapes as the port's state dicts,
and the same scores within float32 rounding. (The references import
nothing of the port; this test imports both.)"""

import torch

from portbench import weights
from portbench.reference import basis, glow, ncsn_v1
from portbench.reference.precision import Precision, stack

NCSN = {"n_filters": 8, "num_classes": 3, "data_shape": [16, 16, 1],
        "init": {"norm_embed_mean": 1.0}}
GLOW = {"L": 3, "K": 2, "n_filters": 8, "data_shape": [16, 16, 1],
        "data_range": [-100.0, 20.0], "init": {"coupling_conv3_std": 0.1}}


def _ncsn_port():
    from audiosourcesep_tpu_torch.models.ncsn import get_score_model
    return get_score_model("v1", NCSN["data_shape"], 8, 3, device="meta")


def _glow_port():
    from audiosourcesep_tpu_torch.models import build_glow
    return build_glow((16, 16, 1), L=3, K=2, n_filters=8, learntop=True,
                      data_type="melspec", use_logit=False, alpha=1e-6,
                      minval=-100.0, maxval=20.0, device="meta")


def _load(model, specs, seed):
    state = model.state_dict()
    assert set(state) == {n for n, _, _ in specs}
    assert all(tuple(state[n].shape) == s for n, s, _ in specs)
    w = weights.make(specs, seed, "cpu")
    model = model.to_empty(device="cpu")
    model.load_state_dict(w)
    return model.eval().requires_grad_(False), w


def test_ncsn_v1_reference_equals_the_port():
    from audiosourcesep_tpu_torch import nn
    specs = ncsn_v1.param_specs(NCSN)
    (m0, w0), (m1, w1) = _load(_ncsn_port(), specs, 11), \
        _load(_ncsn_port(), specs, 12)
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 3, 16, 16, 1, generator=g)
    y = torch.tensor([0, 1, 2])
    want = ncsn_v1.score(stack([w0, w1]), x, y, NCSN)
    for routed in (False, True):
        nn.set_winograd(routed)
        try:
            with torch.no_grad():
                got = torch.stack([m0(x[0], y), m1(x[1], y)])
        finally:
            nn.set_winograd(False)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # a control in tf32, bf16 or fp8 is measurably off
    for mode, lo in (("tf32", 1e-5), ("bf16", 1e-4), ("fp8", 1e-3)):
        low = ncsn_v1.score(stack([w0, w1]), x, y, NCSN, Precision(mode))
        assert (low - want).abs().max() > lo * want.abs().max()


def test_glow_reference_score_equals_the_port():
    specs = glow.param_specs(GLOW)
    (m0, w0), (m1, w1) = _load(_glow_port(), specs, 12), \
        _load(_glow_port(), specs, 13)
    x = torch.rand(2, 3, 16, 16, 1,
                   generator=torch.Generator().manual_seed(1))
    x = x * 120.0 - 100.0
    params = stack([w0, w1])
    want = glow.score(params, x, GLOW)
    got = torch.stack([m0.score(x[0]), m1.score(x[1])])
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # log p differs by the x-independent log-determinants alone
    diff = torch.stack([m0.log_prob(x[0]), m1.log_prob(x[1])]) \
        - glow.log_prob(params, x, GLOW)
    assert (diff.max(dim=1).values - diff.min(dim=1).values).max() <= 1e-3


def test_basis_step_equals_the_port_mixing():
    from audiosourcesep_tpu_torch.separation.mixing import mixing_process
    g_port, grad_port = mixing_process("melspec", "dB")
    xs = torch.rand(2, 4, 8, generator=torch.Generator().manual_seed(2))
    g, grad = basis.mix(xs * 50.0 - 40.0)
    assert torch.allclose(g, g_port(xs * 50.0 - 40.0), atol=1e-5)
    assert torch.allclose(grad, grad_port(xs * 50.0 - 40.0), atol=1e-6)
    eta, lam, scale = basis.constants([1.0, 0.1, 0.01], 1, 2e-5)
    assert abs(eta - 2e-5 * 100.0) < 1e-9 and abs(lam - 100.0) < 1e-3
    assert abs(scale - (2 * eta) ** 0.5) < 1e-7
