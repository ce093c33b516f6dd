"""NCSN RefineNet score networks (port of ``audiosourcesep_tpu/models/ncsn/refinenet.py``).

``RefineNetDilated(x, sigma_idx) -> score`` with ``x`` NHWC (as in the JAX
package) and ``sigma_idx`` an integer vector, one noise-level index per
sample. Inside, activations are NCHW in ``channels_last`` memory.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ... import nn
from ...utils.profiling import span
from .layers import RefineBlock, ResidualBlock, make_normalizer


class RefineNetDilated(torch.nn.Module):
    """4-cascade dilated ResNet encoder + 4 RefineNet decoder blocks.

    ``num_classes`` set -> v1: every norm is conditional on the noise index
    and the input is rescaled ``2x - 1`` unless ``logit_transform``.
    ``sigmas`` set -> v2: unconditional norms; the output is divided by
    ``sigmas[sigma_idx]``. ``compute_dtype=torch.bfloat16`` runs the convs
    in bf16 (norm statistics stay f32) and returns the input's dtype.

    Parameters are allocated uninitialised on ``device`` (``"meta"``
    allocates nothing); :meth:`reset_parameters` draws them.
    """

    def __init__(self, data_shape: Sequence[int], ngf: int,
                 num_classes: Optional[int] = None,
                 sigmas: Optional[np.ndarray] = None,
                 logit_transform: bool = False, deeper: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if (num_classes is None) == (sigmas is None):
            raise ValueError("exactly one of num_classes (v1) / sigmas (v2) "
                             "must be given")
        self.data_shape = tuple(data_shape)
        self.ngf = ngf
        self.num_classes = num_classes
        self.logit_transform = logit_transform
        self.compute_dtype = compute_dtype
        self.act = nn.elu
        # the leaves a traced capture times inside a forward: the convs,
        # for the non-conv share, and v2's pools (its max-pool CRP)
        self.traced_leaves = ("conv",) if sigmas is None else ("conv",
                                                               "pool")
        if sigmas is None:
            self.sigmas = None
        else:
            self.register_buffer("sigmas", torch.tensor(
                np.asarray(sigmas, np.float32), device=device),
                persistent=False)
        nc = num_classes
        C = self.data_shape[-1]

        def res(i, o, resample=None, dilation=None):
            return ResidualBlock(i, o, nc, resample, dilation, self.act,
                                 device)

        def refine(planes, feats, **kw):
            return RefineBlock(planes, feats, nc, self.act, device=device,
                               **kw)

        if not deeper:
            stacks = [
                [res(ngf, ngf), res(ngf, ngf)],
                [res(ngf, 2 * ngf, "down"), res(2 * ngf, 2 * ngf)],
                [res(2 * ngf, 2 * ngf, "down", 2),
                 res(2 * ngf, 2 * ngf, None, 2)],
                [res(2 * ngf, 2 * ngf, "down", 4),
                 res(2 * ngf, 2 * ngf, None, 4)],
            ]
            refines = [
                refine([2 * ngf], 2 * ngf, start=True),
                refine([2 * ngf, 2 * ngf], 2 * ngf),
                refine([2 * ngf, 2 * ngf], ngf),
                refine([ngf, ngf], ngf, end=True),
            ]
        else:
            stacks = [
                [res(ngf, ngf), res(ngf, ngf)],
                [res(ngf, 2 * ngf, "down"), res(2 * ngf, 2 * ngf)],
                [res(2 * ngf, 2 * ngf, "down"), res(2 * ngf, 2 * ngf)],
                [res(2 * ngf, 4 * ngf, "down", 2),
                 res(4 * ngf, 4 * ngf, None, 2)],
                [res(4 * ngf, 4 * ngf, "down", 4),
                 res(4 * ngf, 4 * ngf, None, 4)],
            ]
            refines = [
                refine([4 * ngf], 4 * ngf, start=True),
                refine([4 * ngf, 4 * ngf], 2 * ngf),
                refine([2 * ngf, 2 * ngf], 2 * ngf),
                refine([2 * ngf, 2 * ngf], ngf),
                refine([ngf, ngf], ngf, end=True),
            ]
        self.begin_conv = nn.Conv2d(C, ngf, 3, True, device=device)
        self.end_conv = nn.Conv2d(ngf, C, 3, True, device=device)
        self.normalizer = make_normalizer(ngf, nc, device=device)
        self.n_stacks = [len(s) for s in stacks]
        for si, stack in enumerate(stacks):
            for bi, block in enumerate(stack):
                self.add_module(f"res{si + 1}_{bi + 1}", block)
        self.n_refines = len(refines)
        for ri, block in enumerate(refines):
            self.add_module(f"refine{ri + 1}", block)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw every parameter (Glorot kernels, zero biases, N(0, 0.02)
        norm embeddings) from ``generator``."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        return self

    def count_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def forward(self, x: torch.Tensor, sigma_idx: torch.Tensor
                ) -> torch.Tensor:
        with span("score.forward", leaves=self.traced_leaves):
            return self._forward(x, sigma_idx)

    def _forward(self, x: torch.Tensor, sigma_idx: torch.Tensor
                 ) -> torch.Tensor:
        y = sigma_idx
        in_dtype = x.dtype
        if self.num_classes is not None and not self.logit_transform:
            x = 2.0 * x - 1.0
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        h = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        h = self.begin_conv(h)

        layers = []
        for si, n in enumerate(self.n_stacks):
            for bi in range(n):
                h = self._modules[f"res{si + 1}_{bi + 1}"](h, y)
            layers.append(h)

        ref = self.refine1([layers[-1]], layers[-1].shape[2:], y)
        for i in range(1, self.n_refines):
            skip = layers[-1 - i]
            ref = self._modules[f"refine{i + 1}"]([skip, ref],
                                                  skip.shape[2:], y)

        out = self.normalizer(ref, y, act=self.act)
        out = self.end_conv(out).to(in_dtype)
        if self.sigmas is not None:
            out = out / self.sigmas[y].to(out.dtype)[:, None, None, None]
        return out.permute(0, 2, 3, 1)


def get_score_model(version: str, data_shape, n_filters: int,
                    num_classes: int, sigmas=None,
                    logit_transform: bool = False, deeper: bool = False,
                    compute_dtype: Optional[torch.dtype] = None,
                    device=None) -> RefineNetDilated:
    """v1 takes the class count, v2 the sigma schedule."""
    if version == "v1":
        return RefineNetDilated(data_shape, n_filters,
                                num_classes=num_classes,
                                logit_transform=logit_transform,
                                compute_dtype=compute_dtype, device=device)
    if version == "v2":
        return RefineNetDilated(data_shape, n_filters, sigmas=sigmas,
                                logit_transform=logit_transform,
                                deeper=deeper, compute_dtype=compute_dtype,
                                device=device)
    raise ValueError("version should be 'v1' or 'v2'")
