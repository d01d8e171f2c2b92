"""marlpde_tpu_torch: the PyTorch + CUDA (Hopper) port of marlpde_tpu.

The package mirrors ``marlpde_tpu/`` file for file, so each module's
counterpart is found under the same path.  It covers the Burgers family
(``burger``, ``burger-marl``, ``burger-fd``, ``burger-jax``,
``coupled-burger`` and ``burger-lockstep``: the ABCN, FD, RK3 and compact-FD
schemes, stochastic forcing, the ssm/dsm closures, MSE, spectral and coupled
rewards), ``ks``, and the diffusion, advection and Laplace families
(``diffusion-simple``, ``diffusion-error``, ``diffusion-stencil3``,
``advection-simple``, ``laplace``) through the CLI
(``python -m marlpde_tpu_torch.run``): the whole-batch and the general
per-env Burgers env, the KS env on its ETDRK4 solver, the stencil-action
envs, VRACER in both minibatch modes, checkpoint/resume, testing and
diagnostics, the episode dumps (--save-episodes), --bf16, the --test stage
(evaluation sweeps, SGS diagnostics, makePlot and the other figures, the
error_rl_{N}.json curves, the async .npy sink) and the rlview training
curves (``python -m marlpde_tpu_torch.analysis.rlview``).  It also covers
the other learners: the analytic policy gradient through the differentiable
Burgers rollout (``--learner apg``, ``rl/apg.py``, ``solvers/burger_grad.py``)
and CMA-ES over the Smagorinsky constant (``cmaes-burger``, ``rl/cmaes.py``),
the supervised closure subproject (``ddp/pipeline.py``), and multi-device
training (``--mesh``, ``parallel/mesh.py``: one rank per process on
torch.distributed, NCCL between cards, gloo on the CPU or where ranks share a
card; ``python -m marlpde_tpu_torch.parallel.dryrun`` is the multi-process
dry run).  The two TPU kernels of these paths are CUDA kernels written for
``sm_90a`` (``csrc/``), wrapped in ``kernels/``; each wrapper runs its plain
PyTorch version on CPU tensors and launches the kernel, or raises, on CUDA
tensors.

The port imports torch and numpy (and scipy, and matplotlib where it is
installed, for the test stage's figures), never jax, flax, optax or marlpde_tpu.
State is dataclasses of tensors, the device is passed explicitly, and
``torch.Generator``s take the place of ``jax.random`` keys.
"""

__version__ = "0.1.0"
