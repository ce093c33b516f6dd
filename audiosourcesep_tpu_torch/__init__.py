"""audiosourcesep_tpu_torch — the PyTorch/CUDA port of ``audiosourcesep_tpu``.

The JAX package ``audiosourcesep_tpu`` stays the reference; this package
mirrors its module layout (``nn``, ``ops``, ``bijectors``,
``models.ncsn``, ``models.glow``, ``separation``, ``training``, ``data``,
``evaluation``, ``parallel``, ``utils``) so each
ported function sits at the same path as its counterpart. It imports
``torch`` and never ``jax``.

The one TPU kernel of the reference, the fused Winograd F(2x2,3x3) conv
(``audiosourcesep_tpu/ops/winograd.py``), is two hand-written CUDA kernels
for Hopper here (``csrc/winograd_mma.cu`` for bf16, ``csrc/winograd.cu``
for float32), built with ``nvcc`` at first use (``kernels/build.py``) and
bound with ``ctypes``.

Ported: the NCSN BASIS main path, from wavs to ``results.npz``
(``python -m audiosourcesep_tpu_torch.run_basis_sep``), back to audio
(its ``--inverse``, and
``python -m audiosourcesep_tpu_torch.melspec_inversion_basis``) and its
BSS-Eval score (``evaluation``); NCSN training, from wavs to a TFRecord
dataset (``wav_to_spec``), a trained prior (``train_ncsn``, with
JAX-layout train-state checkpoints) and its samples
(``ncsn_generate_samples``); the Glow prior, from a trained flow
(``train_glow``) and its noise-level chain (``train_noisy_glow``) to a
separation under two Glow priors (``run_basis_sep --model_type glow``);
the image path (``--dataset mnist|cifar10`` in every CLI above), RealNVP
(``train_realnvp``) and Flow++ (``models.build_flowpp``, with its
bisection inverse); multi-process runs on ``torch.distributed``
(``parallel``: data-parallel training with ``--multihost``, BASIS with
the frames or, with ``run_basis_sep --shard_sources``, the sources
sharded over the ranks, and ``parallel.dryrun``); and the NCSNv2 tools
(``utils``, ``technique1_ncsnv2``, ``technique2and4_ncsnv2``), the model
summaries and the profiling helpers. Only ``bench.py`` has no
counterpart yet.
"""

__version__ = "0.1.0"
