"""Drive the PyTorch port's training paths on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build both CUDA kernels from marlpde_tpu_torch/csrc (one nvcc per source,
   started together; sm_90a), with ptxas's registers and spills of each ABCN
   instantiation (N=32 the main path's) and of each width instantiation of
   both routes of the MLP kernel (the narrow route's mlp_forward_kernel and
   the wide route's mlp_wide_kernel, each of which spills a few bytes at
   widths 224 and 256), and the count of
   tensor-core instructions (HGMMA) in the MLP library's SASS;
3. [kernels] each kernel against its plain PyTorch version on the card at the
   shapes of the paths below, with CUDA-event times (median of 20 calls) of
   both and the share of the card's bound (the least time for the bytes the
   call must move or the operations it must do); the MLP kernel's plain
   version is VracerNet on cuBLAS, and each MLP row prints the kernel's time
   over the module's, and at obs <= 4 (the narrow route) the wide route's
   time too, forced, which the routing rule of kernels/mlp.py rests on: ABCN at the flagship batch
   (B=1024), the CLI's (B=10) and at N=64, the MLP at widths 128 and 256 in
   both mu_param modes, at the acting and insert row counts of the CLI, and
   at the KS shapes (obs 32, 16 actions, width 256, sigma_relative, sigma_max
   5; R=16 acting, R=8000 insert); and the timing floor, an empty kernel timed
   the same way;
4. [main] three generations of the flagship fused episode-mode burger-marl
   training (1024 episodes of 500 macro-steps, 32 agents, 200 VRACER updates
   each) through registry.make_env / trainer.train, with launch counts;
5. [breakdown] one more such generation's phases, and [small] a small
   deterministic collection on the card against the same on the CPU; [f2]
   the policy's log_ndtr (fault F2's op) on the card against the CPU over
   |z| from 1e-3 to 1e7, finite, and 0 for a zero cotangent;
5a. [graphs] the CUDA graphs of the training path (utils/graphs.py) against
   the step functions called directly: for run-918 (experience mode, both
   kernels), the fused flagship (episode mode, 1024 envs), run-926 KS and
   run-927 burger-fd, two generations of GRAPH_UPDATES updates on each of
   three paths from one state (eager, one update a graph, 50 updates a
   graph as the trainer runs them), each graphed path held bit for bit
   against eager (trajectories, final states, parameters, Adam's state,
   beta, the counter, the generator, every replay buffer), with seconds per
   collection and ms per update on each path (CUDA events), the kernels'
   launches counted per replay, and under torch.profiler the host's
   launches per macro-step and per update and the device's busy share of
   the collection and of the updates on both graphed paths; then a graphed resume through the CLI
   (run-918 flags: two generations straight against one, a checkpoint with
   the replay, --resume and one more), held bit for bit; and a capture whose
   step drops an old graph into a reference cycle, with the garbage
   collector at a threshold of one allocation (graphs.capture holds the
   collector off: a graph freed during a capture invalidates it);
6. [cli] the run-918 flagship through ``python -m marlpde_tpu_torch.run``'s
   ``main`` (experience mode, korali's ledger, testing, checkpoints,
   diagnostics) for 5 generations, then ``--resume`` for a 6th, in a fresh
   temporary directory; [cli-breakdown] one generation's collection, insert
   and updates (BREAKDOWN_UPDATES of them) timed apart;
7. [cli-w256] one generation at the CLI's default width 256;
8. [fast-off] a deterministic collection through the general per-env env
   (torch.fft solver) against the whole-batch env (ABCN kernel), same weights;
9. [cli-test] the run-918 flags with --test, then --test --best, on the
   [cli] phase's checkpoints (evaluation, the pool sweep, the uncontrolled
   comparison, makePlot's panels);
10. [ks] the run-926 KS flags (scripts/tpu_ks_926.sh) through the CLI for 3
   fused generations of 16 episodes, then --test and --test --best;
   [ks-breakdown] one generation's collection, insert and updates;
11. [ks-agree] a deterministic KS collection on the card against the same on
   the CPU, same weights;
12. [fd] the run-927 burger-fd flags (run-vracer-burger-fd.py: N_dns 1024,
   N = NA = 256, explicit-Euler FD, MSE reward, width 32) through the CLI for
   5 generations, then --test and --test --best; [fd-breakdown] one
   generation's collection, insert and updates timed apart;
13. [fd-agree] a deterministic burger-fd collection on the card against the
   same on the CPU, same weights;
14. [variants] one short CLI run on the card of coupled-burger, burger-jax,
   burger (MSE reward), burger --forcing, burger --ssm and burger --dsm --ic
   forced (coupled-burger and burger also --test), and burger-lockstep
   through registry.make_env and trainer.train, each at a reduced depth;
15. [simple] diffusion-simple, diffusion-error, diffusion-stencil3,
   advection-simple and laplace through the CLI at their run scripts' widths
   (SIMPLE_RUNS' cuts of --NE, --rstart, --maxupd), with korali's ledger
   over the live steps and each episode held to the early-stop rule, then
   --test of each (its figures' data and error_rl_{N}.json);
   [simple-breakdown] a diffusion-simple and a laplace generation's
   collection, insert and updates timed apart; [bf16] the
   error of a 256x256 matmul with and without --bf16's precision, and one
   short diffusion-simple --bf16 run;
16. [simple-oracle] diffusion-simple's defaults with constant actions -2 and
   0 against results/diffusion_oracle_r5.json; [simple-agree] deterministic
   diffusion-simple and laplace collections on the card against the CPU
   (open loop for five seeds, closed loop, and the witnesses that their
   differences are float32 rounding); [simple-learns] the config of
   tests/test_rl.py's diffusion learning test.

17. [apg] burger-jax --learner apg through the CLI (RUN_APG: N = NA = 32,
   N_dns 512, width 256, 16 episodes of 500 RK3 macro-steps, 2 iterations,
   each 2 x 500 + 2 graph replays), then --test of its checkpoint, and the
   peak memory of one backward pass with and without the per-macro-step
   checkpointing (APG_MEMORY_STEPS); then APG_BPTT_ITERATIONS iterations at
   APG_MEMORY_STEPS macro-steps graphed and under graphs.eager(), held bit
   for bit (returns, parameters, incumbent, Adam's state, generator), with
   seconds an iteration both ways, graph replays an iteration, the peak
   memory, and under torch.profiler one more iteration's host calls and
   device busy share; [apg-agree] the return and its gradient (B=4, 20
   macro-steps) and burger_grad's Jacobians on the card against the CPU, in
   float32 and float64, and train_apg's graphed return and gradient
   (apg.Bptt) against the checkpointed episode_return's on the card;
18. [cmaes] cmaes-burger through the CLI (N_dns 512, N 32, population 8,
   500 macro-steps, 3 generations; the objective one graph a macro-step),
   its objective on the card against the CPU at three cs, and graphed
   against graphs.eager() bit for bit with seconds both ways;
19. [ddp] the ddp pipeline at tests/test_ddp.py::TestPipelineScale's scale
   (N=1024 DNS of 4000 steps, n_les 128, 80 epochs, a-priori and
   a-posteriori checks) and a transfer step with frozen layers, graphed (one
   graph per DNS forcing block, per epoch, per LES step) and under
   graphs.eager(), bit for bit, with seconds per stage both ways; and the
   card's DNS against the CPU's from the same draws;
20. [mesh] the run-918 flags with --mesh through the CLI at a world of 1 on
   NCCL (RUN_MESH: 3 generations, updates from the second, replays of 50
   updates captured with their all_reduces, then --resume for a fourth);
   the same 3 generations under graphs.eager(), held bit for bit against the
   graphed ones; the captures of each run (one macro-step and one chunk of
   updates);
   seconds per generation and ms per update graphed and eager (CUDA events
   around the replays) beside [cli-breakdown]'s, and the all_reduces per
   update, counted per replay as the kernels' launches are;
21. [mesh-2] two ranks on the card under gloo, spawned by
   ``python -m marlpde_tpu_torch.parallel.dryrun --device cuda``: the dry run
   (both minibatch modes, train states equal bit for bit across the ranks,
   the DCP checkpoint restored on each), then the run-918 flags at 5 envs a
   rank for 2 generations (RUN_MESH2), each rank launching both kernels.
22. [lockstep] run 918 (scripts/torch_lockstep.py: the CLI's flags at full
   width from the JAX package's seed-42 weights, 5 generations, the 5th with
   korali's 2500 updates) eagerly on the card, fed the action noise and
   minibatch draws of the tape that the JAX package's CPU run in
   scripts/lockstep_918.npz took, and held against that run: generations
   1-4 (no updates: returns, ep_len, cursor, blow-ups and replay rows)
   within the script's TOL_COLLECT (1e-3), its first FIRST_UPDATES (10)
   updates within TOL_FIRST_UPDATES (2e-3), and the gap of each of the
   first 200 updates printed beside the port's CPU float32 run's (the
   npz's yardstick), with the first update at which the card's gap
   exceeds 10 times the CPU's; both kernels launch on this path, and the
   port's generator never moves.

The [kernels] phase also holds the MLP kernel at the [simple] shapes of all
five presets, at obs 128/256 with widths 128/256 (WIDE_INPUTS) and at the
shape of [apg]'s --test stage (APG_HEADS), and both kernels at the shapes
that only the mesh paths run: [mesh]'s update rows, [mesh-2]'s run-918 CLI at
5 envs a rank (ABCN B=5; MLP acting, insert and update rows, MESH_ROWS) and
its dry run's small flagship (ABCN B=1 at N=16; MLP width 32, DRYRUN_ROWS).
It ends with the experience-mode loss head (rl/vracer_loss.py: two
launches an update, replacing no TPU kernel) against its plain version,
forward and backward, at the minibatch and learner config of every
experience-mode path (HEAD_PATHS: runs 918, 926 and 927, the benchmark's ks
cell, the [simple] presets and the [variants]): its errors, its time eager
and inside a graph, the plain chain's both ways and its kernel nodes, its
byte bound and the timing floor.  Every path's launches include the loss
head's, held at two an experience-mode update (counted through
trainer.run_updates) and none elsewhere.
A [timing] line gives each phase's seconds.

Every training path runs its updates and its collections' macro-steps as
CUDA graph replays ([mesh-2]'s gloo ranks their collections only: gloo
all-reduces through the host, which a capture refuses), APG, CMA-ES and ddp
their loops' bodies, and a replay adds to
each kernel's count the launches its capture saw.  Launch counts are set to 0 just before each path and read
just after; the comparisons of a kernel with its plain version are not
counted.  The
flagship Burgers paths (main, cli, cli_w256, cli_test, mesh, mesh2, lockstep;
mesh2's counts are its ranks' summed) must launch both kernels; the paths ks,
ks_test, fd, fd_test, variants, simple, simple_test, bf16 and apg the MLP
kernel and never the ABCN kernel: their configs run the
general per-env env on torch.fft or have no Burgers solver, as in the JAX
package (apg launches the MLP kernel only in its --test stage: training
differentiates the module, as JAX differentiates flax's apply); cmaes and
ddp launch neither (no VRACER policy; their own ABCN loops on torch.fft).
Standard output ends
with one JSON line of kernel results (launches of the [cli] path, and of each
path under "launches_by_path"), then the contract line {"ok": true,
"device": {...}}.  Without a CUDA card, or without the package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

FLAGSHIP = dict(N_dns=512, grid_size=32, num_actions=32, num_agents=32, dt=1e-3,
                T=5.0, nu=0.02, episode_length=500, ic_case="turbulence",
                spectral_reward=True, noise=0.0)
NUM_ENVS = 1024
GENERATIONS = 3
ABCN_TOL = 1e-5     # relative to each field's max |value|
# the card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): the bound of a
# kernel is the larger of its bytes over HBM_BPS and its operations over the
# peak of their type
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
MLP_TOL = 2e-5      # absolute, as tests/test_pallas.py holds the Pallas MLP
HEAD_TOL = 1e-6     # the loss head against its plain version, of each tensor's max |plain|
HEAD_LAUNCHES = 2   # the loss head's launches an experience-mode update
FAST_OFF_TOL = 1e-4  # relative to each tensor's max |value|: float32, two solvers
# the run-918 flagship (scripts/tpu_flagship_918.sh)
RUN_918 = ("burger-marl --nagents 32 --specreward --dforce --ic turbulence --width 128 "
           "--iex 0.1 --numenvs 10 --mbsize 8 --maxupd 2500 --testepisodes 8 "
           "--rscale cumulative --trust forward --diag").split()
# the run-926 KS flags (scripts/tpu_ks_926.sh); the DNS pool is 16 rows of N=1024
RUN_926 = ("ks --N 16 --NA 16 --ndns 16 --sigma-max 5 --iex 0.01 --numenvs 16 --maxupd 1000 "
           "--fused --testepisodes 16 --run 926").split()
# experience-mode updates timed by each [*-breakdown] (its ms per update)
BREAKDOWN_UPDATES = 500
# [graphs]: the updates of each of its generations, and of its profiled window
GRAPH_UPDATES = 100
PROFILED_UPDATES = 100
KS_AGREE_TOL = 1e-4  # relative to each tensor's max |value|: float32, cuFFT against pocketfft
# the run-vracer-burger-fd.py config (bench.py:79-84): N_dns 1024, N = NA = 256,
# turbulence IC, MSE reward, width 32, iex 0.005, at the CLI's default mbsize.
# --dforce: the actions are the forcing itself, as in bench.py's cell.  The
# CLI's default multiplies them by d2u/dx2 (Burger.py:445-450), which explicit
# Euler at N=256 cannot take: an untrained policy's episodes all blow up in
# their first macro-step, in the JAX package too
RUN_927 = ("burger-fd --dforce --NDNS 1024 --numenvs 10 --maxupd 2500 --testepisodes 8 "
           "--run 927").split()
# relative to each tensor's max |value|: float32 torch.fft on the card against
# pocketfft, the MLP kernel against the module.  Open loop (the card's env on
# the CPU's actions, its policy on the CPU's observations) at FD_AGREE_TOL;
# closed loop the policy amplifies the rounding of its version-0 observation
# d2u/dx2 in the actions, held at FD_CLOSED_TOL (4.0e-4 on an H100)
FD_AGREE_TOL = 1e-4
FD_CLOSED_TOL = 1e-3
# the [variants] depth: 50 macro-steps of 10 sub-steps, 2 generations of 16
# episodes where none blows up
VARIANT_DEPTH = "--episodelength 50 --T 0.5 --NE 1600".split()
# --dforce: the actions are the forcing itself.  The last entry is the CLI's
# default run (MSE reward, actions scaling d2u/dx2), where an untrained
# policy may blow up some of its episodes: its check counts them
VARIANTS = ("coupled-burger", "burger-jax --dforce", "burger --dforce",
            "burger --dforce --forcing", "burger --dforce --ssm",
            "burger --dforce --dsm --ic forced", "burger")
# the policy heads of the [variants] runs: (actions, sigma_max, iex)
VARIANT_HEADS = {"coupled": (1, 1.0, 0.1), "burger": (32, 1.0, 0.1), "jax": (32, 0.1, 0.01)}
# [simple]: each preset at its run script's widths and the CLI's 16 episodes a
# generation (an untrained policy's live steps a generation, on the CPU:
# 147, 8000, 17, 48 and 1600), cut in --NE, --rstart (below the scripts'
# 32768 / 16384 / 262144, so that updates run) and --maxupd
SIMPLE_RUNS = {
    "diffusion-simple": "--NE 900 --rstart 300 --maxupd 200 --testfreq 2",
    "diffusion-error": "--NE 16000 --rstart 4000 --maxupd 200",
    "diffusion-stencil3": "--NE 300 --rstart 100 --maxupd 200",
    "advection-simple": "--NE 480 --rstart 150 --maxupd 200",
    "laplace": "--NE 4800 --rstart 1600 --maxupd 200",
}
# the loss head's [kernels] rows: the learner config the CLI makes of the
# flags of every experience-mode path here, and of the benchmark's ks cell
# (benchmark/configs/ks.json: 32 actions); paths whose loss heads agree
# (minibatch shape, trust region, temper, bounds, agent coupling) share a row
HEAD_PATHS = {"run918": RUN_918, "run926": RUN_926, "run927": RUN_927,
              "ks-cell": "ks --N 32 --NA 32 --ndns 16 --sigma-max 5 --iex 0.001".split(),
              **{name: [name] + cut.split() for name, cut in SIMPLE_RUNS.items()},
              **{"variant " + v: v.split() + VARIANT_DEPTH for v in VARIANTS}}
# the MLP shapes of the [simple] paths: (obs, actions, width, mu_param,
# sigma_max, iex) of the run scripts (diffusion-simple, -error, -stencil3,
# advection-simple, laplace), at the acting rows (16 envs x agents) and the
# insert rows (16 x episode length x agents)
SIMPLE_HEADS = {"diffusion": ((128, 128, 128, "sigma_relative", 5.0, 3.0), (16, 8000)),
                "error": ((128, 128, 128, "sigma_relative", 0.1, 0.01), (16, 8000)),
                "stencil3": ((128, 2, 128, "sigma_relative", 5.0, 3.0), (16, 8000)),
                "advection": ((32, 64, 128, "absolute", 0.5, 0.05), (16, 8000)),
                "laplace": ((4, 3, 128, "absolute", 1.0, 0.1), (512, 51200))}
# obs widths the kernel refused while it staged W1 and the x tile in shared
# memory: burger-fd and ks at width 256 (obs 256 and 128), diffusion-simple
# at N=256
WIDE_INPUTS = {"d256w128": ((256, 256, 128, "absolute", 0.5, 0.005), (10, 5000)),
               "d256w256": ((256, 256, 256, "absolute", 0.5, 0.005), (10, 5000)),
               "d128w256": ((128, 128, 256, "sigma_relative", 5.0, 0.01), (16, 8000))}
# the MLP shape of [apg]'s --test stage: burger-jax's policy (obs 32, 32
# actions, width 256, sigma_max 0.1, iex 0.01) with the sigma-relative mean,
# acting for 8 test episodes of one agent
APG_HEADS = {"apg": ((32, 32, 256, "sigma_relative", 0.1, 0.01), (8,))}
# results/diffusion_oracle_r5.json (the JAX package, float32 on the CPU):
# diffusion-simple's defaults, 64 episodes of constant actions
ORACLE = {-2.0: (0.2499985545873642, 500.0), 0.0: (-0.0008172778179869056, 56.0)}
ORACLE_TOL = 1e-6    # absolute on the mean return: float32 sums of 500 rewards of ~5e-4
# relative to each tensor's max |value|.  Open loop (the card's env on the
# CPU's actions, its policy on the CPU's observations): the policy's outputs
# (the MLP kernel against the module, ~1.5e-6 on an H100) at SIMPLE_AGREE_TOL;
# the env's at SIMPLE_ENV_TOL: diffusion's explicit stencils, stepping with a
# policy's 128 weights, amplify float32 rounding (rewards 1.2e-5 to 4.2e-4
# over the five seeds on an H100, of the order of the CPU's own float32
# against float64 on the same actions: 4.4e-5, obs 8.5e-5): the limit sits
# 2.4x above the largest reading.  Closed loop the policy acts on the
# amplified field, at SIMPLE_CLOSED_TOL (1.0e-4 to 1.16e-4 on an H100).  In
# float64 on both devices the same program's rounding stays near 1e-13
SIMPLE_AGREE_TOL = 1e-4
SIMPLE_ENV_TOL = 1e-3
SIMPLE_CLOSED_TOL = 1e-3
SIMPLE_AGREE_SEEDS = (2, 3, 5, 7, 11)   # of the weights' perturbation, open loop
SIMPLE_F64_TOL = 1e-8
# [apg]: burger-jax (run-vracer-burger-jax.py: N = NA = 32, N_dns 512, width
# 256, RK3) through the CLI's --learner apg, 16 episodes of 500 macro-steps an
# iteration, cut to 2 iterations by --NE; --dforce: the actions are the
# forcing itself (the CLI's default scales d2u/dx2 by them).  With the
# absolute mean an untrained policy's episodes blow up for most initial
# weights (-inf returns, NaN gradients: JAX keys 42, 0, 3 of 0-3 and 42, port
# seeds 42, 1, 2, 3 on the CPU under PyTorch 2.13, whose trunc_normal_ draws
# other weights than other versions'), and the CLI's lr 1e-3 blows up the
# second iteration from the one whose episodes survive, in JAX too from the
# same weights: the reference's behaviour, checked on the CPU-drawn weights
# of APG_BLOWN_SEED.  The sigma-relative mean starts from zero actions, the
# uncontrolled LES, whatever the weights, and APG improves it in both
# packages (on the CPU, scripts/learner_compare.py apg: JAX -14.0013,
# -13.7011, -13.3070; the port -14.0012, -13.7086, -13.3249)
RUN_APG = ("burger-jax --dforce --muparam sigma_relative --learner apg --numenvs 16 "
           "--NE 16000 --run 81").split()
APG_BLOWN_SEED = 42
# the depth of [apg]'s memory measurement with and without the checkpointing:
# the saved tensors grow with the macro-steps (at the CLI's 500, 11.1 and
# 205.9 MiB on an H100)
APG_MEMORY_STEPS = 100
# [apg]'s graphed APG iterations against graphs.eager() at APG_MEMORY_STEPS
# macro-steps (the CLI's 16 episodes, lr 1e-3): timed iterations, then one more
# under torch.profiler
APG_BPTT_ITERATIONS = 2
# [apg-agree]: the return and its gradient at B=4 over 20 macro-steps of 10
# RK3 sub-steps (T 0.2) at burger-jax's widths, card against CPU.  float32:
# within AGREE_FACTOR times the CPU's own float32 distance from float64 on the
# same weights (5.3e-6 on the return, 4-7e-5 on the gradients); float64 on
# both devices at AGREE_F64_TOL.  The Jacobians of burger_grad likewise
APG_AGREE = dict(N_dns=512, grid_size=32, num_actions=32, dt=1e-3, T=0.2, episode_length=20,
                 dforce=True)
AGREE_FACTOR = 10.0
AGREE_F64_TOL = 1e-8
# [f2]: the arguments of log_ndtr at the first non-finite updates of run 926
# (seed 7, generation 103) and run 918 (seed 42, generation 159) on the card,
# and the relative tolerance of log_ndtr on the card against the CPU (float32,
# a few ulps of erf, erfc, log and exp)
F2_ARGS = (-47171.656, -94777.72)
F2_TOL = 1e-5
# [cmaes]: run-cmaes-burger.py's config (N_dns 512, N 32, population 8, 500
# macro-steps of 10 ABCN sub-steps) through the CLI, cut to 3 generations;
# the card's objective against the CPU's at CMAES_CS, within AGREE_FACTOR
# times the CPU's float32 distance from float64 (2.3e-5 on the CPU)
RUN_CMAES = "cmaes-burger --numgen 3".split()
CMAES_CS = (0.0, 0.2, 0.8)
# [ddp]: tests/test_ddp.py::TestPipelineScale at its sizes and limits, in
# float64 as it runs, on draws from CPU generators (DDP_SEEDS: the data's,
# the closure's) that the CPU run of the same seeds shares; the closure's
# initial weights (trunc_normal_) and permutations differ between PyTorch
# versions, so the card is held against the CPU of the same machine.  The
# float32 DNS is compared over DDP_AGREE_STEPS
DDP_SEEDS = (7, 1)
DDP_AGREE_STEPS = 200
# [ddp]: calls of the rollout and the transfer step timed each way (graphed,
# each call with its own capture, and under graphs.eager()); the medians
DDP_REPEATS = 5
# [mesh]: the run-918 flags with --mesh at a world of 1 (NCCL), cut to 3
# generations (--NE 15000) of MESH_UPDATES updates (--maxupd); --rstart 10000
# makes generation 2 the first with updates (5000 live steps a generation),
# and --resume --NE 20000 adds a fourth, whose replay starts empty, as in JAX
MESH_UPDATES = 250
RUN_MESH = RUN_918 + f"--mesh --maxupd {MESH_UPDATES} --rstart 10000 --run 91".split()
# [mesh-2]: the run-918 flags on 2 ranks sharing the card (gloo), 5 envs a
# rank, cut to 2 generations (--NE 10000) of 50 updates (--rstart 5000: the
# two shards' 5000 live steps warm the replay in generation 1)
RUN_MESH2 = RUN_918 + "--NE 10000 --rstart 5000 --maxupd 50 --run 92 --mesh".split()
# the MLP rows of the mesh paths that no other path runs: [mesh]'s updates
# (mbsize 8 x 32 agents) and [mesh-2]'s run-918 CLI on 2 ranks (acting,
# insert, updates); the dry run's on 2 ranks (acting, insert, updates)
MESH_ROWS = (256, 160, 80000, 128)
DRYRUN_ROWS = (4, 20, 32)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# experience-mode updates run through trainer.run_updates since the last
# _reset_launches (_count_experience_updates)
_experience_updates = 0


def _reset_launches():
    """Set the kernels' launch counters, and the experience-mode updates
    counted beside them, to 0: just before each path."""
    global _experience_updates
    from marlpde_tpu_torch.kernels import abcn, mlp
    from marlpde_tpu_torch.rl import vracer_loss
    abcn.launches = mlp.launches = vracer_loss.launches = 0
    _experience_updates = 0


def _launches():
    """The kernels' launches since ``_reset_launches``, and the
    experience-mode updates run since: the loss head's launches are
    HEAD_LAUNCHES times those."""
    from marlpde_tpu_torch.kernels import abcn, mlp
    from marlpde_tpu_torch.rl import vracer_loss
    return dict(abcn_macro_step=abcn.launches, mlp_forward=mlp.launches,
                vracer_loss=vracer_loss.launches, experience_updates=_experience_updates)


def _no_launches():
    return dict.fromkeys(("abcn_macro_step", "mlp_forward", "vracer_loss",
                          "experience_updates"), 0)


def _count_experience_updates():
    """Wrap trainer.run_updates (which the trainer, the mesh and the CLI call
    through the module) to count the experience-mode updates it runs."""
    from marlpde_tpu_torch.train import trainer
    run_updates = trainer.run_updates

    def counted(rl_cfg, ts, rep, generator, n, *args, **kw):
        global _experience_updates
        if rl_cfg.minibatch_mode == "experience":
            _experience_updates += n
        return run_updates(rl_cfg, ts, rep, generator, n, *args, **kw)

    trainer.run_updates = counted


def median_ms(fn, n=20):
    """Device time of one call of ``fn``: CUDA events, median of ``n`` calls.
    A spin kernel holds the stream while the call is enqueued, so the events
    time the device work alone, not the host's launch overhead."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(4 * max(enqueue_s, 1e-4) * 2e9)   # 4x the enqueue time at <= 2 GHz
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


def abcn_bound(B, N, n_intermediate):
    """(bound in ms, what bounds it, direct-DFT ms) of one ABCN call.  Bytes:
    the 7 (B, N) fields and nu read once, the 7 outputs written once, and the
    kernel's lane tables ((2 log2 N + 1) N floats, N ints).  Operations, per
    env and sub-step: two radix-2 FFTs of 5 N log2 N float32 flops each and
    28 N for q, the update, ek and the 1/N; the direct DFT that the TPU kernel
    does would be 8 N^2 for the two transforms."""
    L = N.bit_length() - 1
    nbytes = 4 * (7 * B * N + B) + 4 * 7 * B * N + 4 * ((2 * L + 1) * N + N)
    flops = B * n_intermediate * (10 * N * L + 28 * N)
    t_bytes, t_ops = nbytes / HBM_BPS, flops / FP32_FLOPS
    direct = B * n_intermediate * (8 * N * N + 28 * N) / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", 1e3 * direct


def mlp_bound(R, obs, width, act):
    """(bound in ms, what bounds it) of one MLP call: the three TF32 tensor-core
    products of 2 R W^2 flops each (3xTF32 layer 2) at the TF32 peak, against
    x, the weights and the 3 outputs moved once (layer 1 and the heads, 2 R W
    (obs + 2 act + 1) float32 flops, take less time on their own units)."""
    nbytes = 4 * (R * obs + obs * width + width + width * width + width
                  + width * (2 * act + 1) + 2 * act + 1 + R * (2 * act + 1))
    t_bytes = nbytes / HBM_BPS
    t_ops = max(3 * 2 * R * width * width / TF32_FLOPS,
                2 * R * width * (obs + 2 * act + 1) / FP32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _abcn_row(args, kw, label):
    """The ABCN kernel against its plain version on ``args``: the error
    relative to each field's max |value|, kernel and plain ms, the bound."""
    import torch
    from marlpde_tpu_torch.kernels import abcn

    B, N = args[0].shape
    out = abcn.abcn_macro_step(*args, **kw)
    ref = abcn.abcn_macro_step_reference(*args, **kw)
    torch.cuda.synchronize()
    check(all(o.shape == (B, N) and torch.isfinite(o).all() for o in out),
          f"abcn output at {label}")
    abs_err = max((o - r).abs().max().item() for o, r in zip(out, ref))
    rel_err = max(((o - r).abs().max() / r.abs().max().clamp(min=1.0)).item()
                  for o, r in zip(out, ref))
    ms = median_ms(lambda: abcn.abcn_macro_step(*args, **kw))
    plain_ms = median_ms(lambda: abcn.abcn_macro_step_reference(*args, **kw))
    bound_ms, bound_by, direct_ms = abcn_bound(B, N, kw["n_intermediate"])
    print(f"[kernels] abcn_macro_step {label} B={B} N={N} n_intermediate="
          f"{kw['n_intermediate']}: max abs err {abs_err:.3e}, {rel_err:.3e} relative to "
          f"each field's max |value| (tolerance {ABCN_TOL:g} relative: float32 radix-2 "
          f"FFTs in another order than torch.fft); kernel {ms:.5f} ms, plain {plain_ms:.4f} "
          f"ms; bound {bound_ms:.6f} ms ({bound_by}; a direct DFT's operations "
          f"{direct_ms:.6f} ms), {100 * bound_ms / ms:.2f}% of it; no single PyTorch call "
          f"computes this function")
    check(rel_err <= ABCN_TOL, f"abcn kernel disagrees with its plain version at {label}: "
                               f"{rel_err:.3e}")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def loss_head_bound(n, na, A):
    """Bound in ms of one loss-head call, forward and backward (bytes): its
    inputs read once (the actions and both policies' mu and sigma, 5 n na A
    floats; V, rewards and vtg_next, 3 n na) and its outputs written once
    (rho and the flags, 5 bytes a row; the 9 metrics; dL/dV, dL/dmu,
    dL/dsigma).  Its operations, two log densities with two log_ndtr each an
    element, take less time than that on the card's float32 units."""
    R, E = n * na, n * na * A
    nbytes = 4 * (5 * E + 3 * R) + 5 * R + 36 + 4 * (R + 2 * E)
    return 1e3 * nbytes / HBM_BPS


def _head_configs(dev):
    """{tags: learner config} of HEAD_PATHS, one entry for the paths whose
    loss heads agree."""
    from marlpde_tpu_torch import run
    out = {}
    for tag, argv in HEAD_PATHS.items():
        _, cfg, _ = run.make_workload(run.build_parser().parse_args(argv), device=dev)
        check(cfg.minibatch_mode == "experience", f"loss head {tag}: {cfg.minibatch_mode} mode")
        key = (cfg.mini_batch_size, cfg.num_agents, cfg.act_dim, cfg.trust_region,
               cfg.cutoff_dim_norm, cfg.multi_agent_correlation, cfg.multi_agent_relationship,
               cfg.action_low, cfg.action_high, cfg.gamma, cfg.value_coef, cfg.reward_floor,
               cfg.scaled_reward_floor)
        tags, _ = out.get(key, ((), cfg))
        out[key] = (tags + (tag,), cfg)
    return {", ".join(tags): cfg for tags, cfg in out.values()}


def _loss_head_row(dev, tag, cfg, floor_ms):
    """The loss head (rho_terms, then experience_loss: the loss's metrics and
    its gradients) against its plain version (autograd through the loss) at
    one path's minibatch and learner config: near and far rows, actions at
    both bounds; the errors, the times eager and as a graph replay, kernel
    nodes."""
    import numpy as np
    import torch
    from marlpde_tpu_torch.rl import vracer_loss as VL
    from marlpde_tpu_torch.utils import graphs

    n, na, A = shape = (cfg.mini_batch_size, cfg.num_agents, cfg.act_dim)
    lb, ub = cfg.action_low, cfg.action_high
    mid, half = 0.5 * (lb + ub), 0.5 * (ub - lb)
    rng = np.random.default_rng(n * na * A)
    mu = mid + rng.standard_normal(shape) * 0.08 * half
    sigma = rng.uniform(0.01, 0.12, shape) * half
    far = rng.random((n, 1, 1)) < 0.3
    near = 0.01 * min(1.0, np.sqrt(32 / A))   # a near row's joint ratio stays near 1
    mu_b = mu + rng.standard_normal(shape) * np.where(far, 0.1, 0.2 * near) * half
    sigma_b = sigma * np.where(far, rng.uniform(0.7, 1.4, shape),
                               rng.uniform(1 - near, 1 + near, shape))
    actions = np.clip(mu_b + sigma_b * rng.standard_normal(shape), lb, ub)
    actions.reshape(-1)[rng.choice(actions.size, 4, replace=False)] = [lb, lb, ub, ub]
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    rows = dict(actions=f(actions), mu=f(mu_b), sigma=f(sigma_b),
                rewards=f(rng.standard_normal((n, na)) * 0.3))
    out = [f(rng.standard_normal((n, na))).requires_grad_(True), f(mu).requires_grad_(True),
           f(sigma).requires_grad_(True)]
    beta, scale, vtg_next = f(0.3), f(0.7), f(rng.standard_normal((n, na)))
    cutoff = f(4.0)
    inv_cutoff = torch.reciprocal(cutoff)
    mu_d, sigma_d = out[1].detach(), out[2].detach()

    def op():
        rho, off, terms = VL.rho_terms(cfg, rows, mu_d, sigma_d, scale, cutoff, inv_cutoff)
        metrics, (_, grads) = VL.experience_loss(cfg, beta, out, rows, vtg_next, terms)
        return (rho, off, metrics["loss"], *grads)

    def plain():
        rho, _ = VL.joint_rho(cfg, rows["actions"], mu_d, sigma_d, rows["mu"], rows["sigma"])
        off = ~((rho > inv_cutoff) & (rho < cutoff))
        loss, _ = VL.loss_experience(cfg, beta, out, rows, vtg_next, scale, cutoff)
        return (rho, off, loss.detach(), *torch.autograd.grad(loss, out))

    before = VL.launches
    got = op()
    launched = VL.launches - before
    want = plain()
    torch.cuda.synchronize()
    errs = {name: ((g - w).abs().max() / w.abs().max()).item()
            for name, g, w in zip(("rho", "dV", "dmu", "dsigma"), got[:1] + got[3:],
                                  want[:1] + want[3:])}
    loss_err = abs(float(got[2]) - float(want[2])) / max(abs(float(want[2])), 1.0)
    same = sum(int((g == w).sum()) for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]))
    total = sum(g.numel() for g in got[:2] + got[3:])
    check(torch.equal(got[1], want[1]), f"loss head {tag}: off-policy flags differ")
    check(launched == HEAD_LAUNCHES, f"loss head {tag}: {launched} launches, not {HEAD_LAUNCHES}")
    ms, plain_ms = median_ms(op), median_ms(plain)
    _, g_op = graphs.capture(f"loss head {tag}", op, dev)
    _, g_plain = graphs.capture(f"plain loss head {tag}", plain, dev)
    graph_ms, plain_graph_ms = median_ms(g_op.replay), median_ms(g_plain.replay)
    bound_ms = loss_head_bound(n, na, A)
    print(f"[kernels] vracer_loss {tag}: {n}x{na}x{A} ({cfg.trust_region}, temper "
          f"{VL.rho_temper(cfg):.4g}, bounds [{lb:g}, {ub:g}], {VL.lanes(A)} lanes an agent): "
          f"max |kernel - plain| over max |plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tolerance {HEAD_TOL:g}), loss {loss_err:.3e} of max(|plain|, 1); {same} of "
          f"{total} outputs bitwise equal, flags equal; {launched} launches; kernels {ms:.4f} ms "
          f"eager, {graph_ms:.4f} ms in a graph ({g_op.kernels} kernel nodes); plain chain, "
          f"forward and backward, {plain_ms:.4f} ms eager, {plain_graph_ms:.4f} ms in a graph "
          f"({g_plain.kernels} kernel nodes); bound {bound_ms:.7f} ms (bytes), "
          f"{100 * bound_ms / graph_ms:.3f}% of it in a graph; timing floor {floor_ms:.5f} ms a "
          f"kernel; replaces no TPU kernel (added because the update is launch-bound)")
    check(all(v <= HEAD_TOL for v in errs.values()) and loss_err <= HEAD_TOL,
          f"loss head {tag} disagrees with its plain version: {errs}, loss {loss_err}")
    return dict(name="vracer_loss", shape=tag, minibatch=list(shape), route="cuda",
                source="marlpde_tpu_torch/csrc/vracer_loss.cu", replaces=None,
                library_ms=None, max_rel_err=max(errs.values()), ms=ms, graph_ms=graph_ms,
                plain_ms=plain_ms, plain_graph_ms=plain_graph_ms, bound_ms=bound_ms,
                bound_by="bytes", kernel_nodes=g_op.kernels, plain_kernel_nodes=g_plain.kernels,
                launches_per_call=launched, floor_ms=floor_ms)


def phase_kernels(env, dev):
    """Each kernel against its plain version at the paths' shapes."""
    import numpy as np
    import torch
    from marlpde_tpu_torch.envs import burger_env, burger_fast, registry
    from marlpde_tpu_torch.kernels import mlp
    from marlpde_tpu_torch.parallel import dryrun
    from marlpde_tpu_torch.rl import networks

    floor_ms = median_ms(lambda: torch.cuda._sleep(0))
    print(f"[kernels] timing floor: an empty kernel (torch.cuda._sleep(0)) times "
          f"{floor_ms:.5f} ms by the same CUDA-event method")
    cfg = env.cfg
    g = torch.Generator(device=dev).manual_seed(1)

    def abcn_inputs(env, B):
        """The ABCN kernel's inputs for B reset envs of ``env`` and random actions."""
        cfg = env.cfg
        st, _ = burger_fast.reset(cfg, env.consts, g, torch.arange(B, device=dev))
        actions = torch.randn(B, cfg.num_agents, cfg.actions_per_agent, generator=g,
                              device=dev) * 0.5
        basis = torch.as_tensor(burger_env.action_basis(cfg), dtype=torch.float32, device=dev)
        af = torch.fft.fft(actions.reshape(B, -1) @ basis)
        return ((st.u, st.v_re, st.v_im, st.fn_re, st.fn_im, st.nu, af.real.contiguous(),
                 af.imag.contiguous()),
                dict(n_intermediate=cfg.n_intermediate, dt=cfg.dt, dx=cfg.les_solver.grid.dx))

    args, kw = abcn_inputs(env, NUM_ENVS)
    flagship = _abcn_row(args, kw, "fused flagship")
    cli = _abcn_row([a[:10].contiguous() for a in args], kw, "run-918 CLI")
    # [mesh-2]: the run-918 CLI at 5 envs a rank, and the dry run's small
    # flagship (one env a rank, 16-point LES, 4 sub-steps)
    mesh2 = _abcn_row([a[:5].contiguous() for a in args], kw, "[mesh-2] run-918 CLI")
    small = registry.make_env("burger", dtype=torch.float32, device=dev, **dryrun.SMALL_FLAGSHIP)
    dry = _abcn_row(*abcn_inputs(small, 1), "[mesh-2] dry run")
    # N=64, off the main path: one env a block, a stage through shared memory
    n64 = torch.Generator().manual_seed(64)
    u = torch.randn(NUM_ENVS, 64, generator=n64) * 0.5 + 1.0
    v, D = torch.fft.fft(u), torch.fft.fft(0.5 * u * u)
    k = torch.fft.fftfreq(64, 1.0 / 64)
    args64 = [t.contiguous().to(dev) for t in (
        u, v.real, v.imag, -k * D.imag, k * D.real, torch.full((NUM_ENVS, 1), 0.02),
        torch.randn(NUM_ENVS, 64, generator=n64) * 0.1,
        torch.randn(NUM_ENVS, 64, generator=n64) * 0.1)]
    wide = _abcn_row(args64, dict(kw, dx=float(2 * np.pi / 64)), "off the main path")
    rows = dict(b10=cli, n64=wide, b5=mesh2, n16_b1=dry)
    results = [dict(name="abcn_macro_step", route="cuda",
                    source="marlpde_tpu_torch/csrc/abcn.cu",
                    replaces="marlpde_tpu/ops/abcn_pallas.py:105", library_ms=None,
                    **dict(flagship, max_abs_err=max(r["max_abs_err"] for r in
                                                     [flagship, *rows.values()])),
                    **{f"{key}_{tag}": row[key] for tag, row in rows.items()
                       for key in ("ms", "plain_ms", "bound_ms")},
                    floor_ms=floor_ms)]

    # flagship acting rows (1024 envs x 32 agents), then the CLI's acting rows
    # (10 x 32) and insert rows (10 x 500 x 32), then the KS rows of the
    # run-926 flags: acting (16 envs x 1 agent) and insert (16 x 500)
    D, A = cfg.obs_dim, cfg.actions_per_agent
    # (R, obs, actions, width, mu_param, sigma_max, iex)
    shapes = ([(NUM_ENVS * cfg.num_agents, D, A, w, m, np.inf, 0.1) for w in (128, 256)
               for m in ("absolute", "sigma_relative")]
              + [(R, D, A, w, "absolute", np.inf, 0.1) for R in (320, 160000) for w in (128, 256)]
              + [(R, 32, 16, 256, "sigma_relative", 5.0, 0.01) for R in (16, 8000)]
              # burger-fd (run 927): obs 256, 256 actions, width 32; acting rows
              # (10 envs x 1 agent), insert rows (10 x 500)
              + [(R, 256, 256, 32, "absolute", 0.05, 0.005) for R in (10, 5000)]
              # [variants] at VARIANT_DEPTH: acting rows (16 envs x 1 agent) and
              # insert rows (16 x 50) of coupled-burger (1 action), the burger
              # runs (32 actions) and burger-jax (32 actions, sigma_max 0.1, iex 0.01)
              + [(R, 32, A, 256, "absolute", sigma_max, iex) for R in (16, 800)
                 for A, sigma_max, iex in VARIANT_HEADS.values()]
              # [mesh]'s update rows (mbsize 8 x 32 agents at a world of 1), then
              # [mesh-2]'s run-918 CLI on 2 ranks: acting (5 envs x 32 agents),
              # insert (5 x 500 x 32) and update rows (8 // 2 x 32)
              + [(R, D, A, 128, "absolute", np.inf, 0.1) for R in MESH_ROWS]
              # [mesh-2]'s dry run on 2 ranks: acting (1 env x 4 agents), insert
              # (1 x 5 x 4) and update rows (16 // 2 x 4)
              + [(R, small.obs_dim, small.act_dim, dryrun.WIDTH, "absolute", np.inf, 0.1)
                 for R in DRYRUN_ROWS]
              # [simple], the wide-input shapes and [apg]'s --test
              + [(R, *head) for head, rows in list(SIMPLE_HEADS.values())
                 + list(WIDE_INPUTS.values()) + list(APG_HEADS.values()) for R in rows])
    mlp_rows = []
    for R, D, A, width, mu_param, sigma_max, iex in shapes:
        x = torch.randn(R, D, generator=g, device=dev)
        net = networks.VracerNet(D, A, width=width, mu_param=mu_param, sigma_max=sigma_max,
                                 init_noise=iex, device=dev, generator=g)
        with torch.no_grad():
            for p in net.parameters():      # non-zero heads, so every output is tested
                p.add_(torch.randn(p.shape, generator=g, device=dev) * 0.1)
            out = mlp.mlp_forward(x, net)
            ref = net(x)
            torch.cuda.synchronize()
            err = max((o - r).abs().max().item() for o, r in zip(out, ref))
            check(out[0].shape == (R,) and out[1].shape == out[2].shape == (R, A),
                  "mlp output shape")
            ms = median_ms(lambda: mlp.mlp_forward(x, net))
            plain_ms = median_ms(lambda: net(x))
            wide = ""
            if not mlp.wide_route(D):
                # the wide route forced where the narrow one runs: the routing rule's evidence
                out_w = mlp.mlp_forward(x, net, route="wide")
                err_w = max((o - r).abs().max().item() for o, r in zip(out_w, ref))
                check(err_w <= MLP_TOL, f"mlp kernel's wide route disagrees with VracerNet "
                                        f"(R={R}, obs={D}, W={width}): {err_w:.3e}")
                ms_w = median_ms(lambda: mlp.mlp_forward(x, net, route="wide"))
                wide = f"; the wide route forced {ms_w:.4f} ms (max abs err {err_w:.3e})"
        bound_ms, bound_by = mlp_bound(R, D, width, A)
        route = "wide" if mlp.wide_route(D) else "narrow"
        print(f"[kernels] mlp_forward R={R} obs={D} W={width} A={A} mu_param={mu_param} "
              f"sigma_max={sigma_max:g} ({route} route): max abs err {err:.3e} (tolerance "
              f"{MLP_TOL:g}: 3xTF32 tensor-core sums against cuBLAS's float32); kernel "
              f"{ms:.4f} ms, plain VracerNet on cuBLAS {plain_ms:.4f} ms, kernel/module "
              f"{ms / plain_ms:.3f}; bound {bound_ms:.5f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of it; no single PyTorch call computes this "
              f"function (the module is a composition of cuBLAS calls){wide}")
        check(err <= MLP_TOL, f"mlp kernel disagrees with VracerNet (R={R}, obs={D}, "
                              f"W={width}, {mu_param}): {err:.3e}")
        mlp_rows.append(dict(R=R, D=D, A=A, iex=iex, width=width, mu_param=mu_param, err=err,
                             sigma_max=sigma_max, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
    for width in (128, 256):
        w2 = torch.randn(width, width, generator=g, device=dev)
        print(f"[kernels] w2_image W={width} (the 3xTF32 split of W2, once per parameter "
              f"version; torch ops): {median_ms(lambda: mlp.w2_image(w2)):.4f} ms")
    flag = {(r["width"], r["mu_param"]): r for r in mlp_rows if r["R"] == NUM_ENVS * 32}
    by_shape = {(r["R"], r["D"], r["A"], r["width"], r["mu_param"], r["sigma_max"], r["iex"]): r
                for r in mlp_rows}
    ks = {R: by_shape[R, 32, 16, 256, "sigma_relative", 5.0, 0.01] for R in (16, 8000)}
    fd = {R: by_shape[R, 256, 256, 32, "absolute", 0.05, 0.005] for R in (10, 5000)}
    var = {(R, A, iex): by_shape[R, 32, A, 256, "absolute", sigma_max, iex]
           for R in (16, 800) for A, sigma_max, iex in VARIANT_HEADS.values()}
    new_shapes = {f"{tag}_r{R}": by_shape[(R, *head)] for tag, (head, rows) in
                  list(SIMPLE_HEADS.items()) + list(WIDE_INPUTS.items())
                  + list(APG_HEADS.items())
                  + [("mesh", ((cfg.obs_dim, cfg.actions_per_agent, 128, "absolute", np.inf,
                                0.1), MESH_ROWS)),
                     ("dryrun", ((small.obs_dim, small.act_dim, dryrun.WIDTH, "absolute",
                                  np.inf, 0.1), DRYRUN_ROWS))] for R in rows}
    results.append(dict(name="mlp_forward", route="cuda",
                        source="marlpde_tpu_torch/csrc/mlp.cu",
                        replaces="marlpde_tpu/ops/mlp_pallas.py:71",
                        max_abs_err=max(r["err"] for r in mlp_rows),
                        ms=flag[128, "absolute"]["ms"],
                        plain_ms=flag[128, "absolute"]["plain_ms"],
                        bound_ms=flag[128, "absolute"]["bound_ms"],
                        bound_by=flag[128, "absolute"]["bound_by"], library_ms=None,
                        ms_w256=flag[256, "absolute"]["ms"],
                        plain_ms_w256=flag[256, "absolute"]["plain_ms"],
                        bound_ms_w256=flag[256, "absolute"]["bound_ms"],
                        **{f"{key}_ks_r{R}": ks[R][key] for R in (16, 8000)
                           for key in ("ms", "plain_ms", "bound_ms")},
                        **{f"{key}_fd_r{R}": fd[R][key] for R in (10, 5000)
                           for key in ("ms", "plain_ms", "bound_ms")},
                        **{f"{key}_{tag}_r{R}": var[R, A, iex][key]
                           for tag, (A, _, iex) in VARIANT_HEADS.items() for R in (16, 800)
                           for key in ("ms", "plain_ms", "bound_ms")},
                        **{f"{key}_{tag}": row[key] for tag, row in new_shapes.items()
                           for key in ("ms", "plain_ms", "bound_ms")}))
    head = [_loss_head_row(dev, tag, cfg, floor_ms) for tag, cfg in _head_configs(dev).items()]
    return results, head


def phase_main_path(env):
    """Three generations of the flagship training through trainer.train."""
    import numpy as np
    import torch
    from marlpde_tpu_torch.kernels import abcn, mlp
    from marlpde_tpu_torch.train import trainer

    rl_cfg = trainer.default_rl_config(env, width=128)
    tc = trainer.TrainerConfig(num_envs=NUM_ENVS, fused=True, seed=0,
                               max_experiences=GENERATIONS * NUM_ENVS * env.episode_length)
    upd = trainer.updates_per_generation(rl_cfg, tc, env.episode_length)
    check(upd == 200, f"updates_per_generation is {upd}, expected 200")
    counts = [(0, 0, 0)]
    substeps = NUM_ENVS * env.episode_length * env.cfg.n_intermediate

    def report(gen, ts, rep, hist):
        torch.cuda.synchronize()
        counts.append((abcn.launches, mlp.launches, mlp.w2_splits))
        dt = hist["wall_time"][-1] - (hist["wall_time"][-2] if gen > 1 else 0.0)
        d_abcn = counts[-1][0] - counts[-2][0]
        d_mlp = counts[-1][1] - counts[-2][1]
        d_split = counts[-1][2] - counts[-2][2]
        print(f"[main] gen {gen}: {dt:.3f} s ({substeps / dt:.1f} LES-substeps/s), "
              f"mean_return {hist['mean_return'][-1]:.6f}, blowups {hist['blowups'][-1]}, "
              f"ep_len {hist['mean_ep_len'][-1]:.1f}, rew_scale {hist['rew_scale'][-1]:.6g}, "
              f"n_upd {hist['updates'][-1]}, launches abcn +{d_abcn} mlp +{d_mlp} "
              f"(W2 split +{d_split})",
              flush=True)
        check(d_abcn == env.episode_length,
              f"gen {gen}: abcn kernel launched {d_abcn} times, expected {env.episode_length}")
        check(d_mlp >= env.episode_length,
              f"gen {gen}: mlp kernel launched {d_mlp} times, expected >= {env.episode_length}")

    _reset_launches()
    mlp.w2_splits = 0
    ts, rep, hist = trainer.train(env, rl_cfg, tc, verbose=False, callback=report)
    launches = _launches()

    check(len(hist["gen"]) == GENERATIONS, f"ran {len(hist['gen'])} generations")
    check(hist["blowups"][0] == 0, f"generation 1 had {hist['blowups'][0]} blowups")
    check(np.isfinite(hist["mean_return"][0]), "generation 1 return is not finite")
    check(hist["mean_ep_len"][0] == env.episode_length, "generation 1 episodes were cut")
    check(all(n == 200 for n in hist["updates"]), f"n_upd per generation {hist['updates']}")
    check(ts.n_updates == 200 * GENERATIONS, f"n_updates {int(ts.n_updates)}")
    check(all(torch.isfinite(p).all() for p in ts.net.parameters()), "params not finite")
    for m in hist["metrics"]:
        check(m and all(np.isfinite(v) for v in m.values()), f"metrics not finite: {m}")
    check(rep.filled == rl_cfg.replay_capacity_episodes, f"replay filled {rep.filled}")
    check(rep.obs.shape == (rep.capacity, env.episode_length, env.num_agents, env.obs_dim),
          f"replay obs shape {tuple(rep.obs.shape)}")
    print(f"[main] last update metrics: {json.dumps(hist['metrics'][-1])}")
    return ts, rep, rl_cfg, launches


def phase_breakdown(env, ts, rep, rl_cfg):
    """Host-clock times of one more generation's phases, each ended by a sync."""
    import torch
    from marlpde_tpu_torch.envs import rollout
    from marlpde_tpu_torch.rl import replay, vracer
    from marlpde_tpu_torch.train import trainer

    g = torch.Generator(device=ts.beta.device).manual_seed(7)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (traj, _), t_collect = timed(lambda: rollout.collect_episodes(
        env, rl_cfg, ts, g, NUM_ENVS, GENERATIONS * NUM_ENVS))
    (ts, rep), t_observe = timed(lambda: (vracer.observe_episodes(rl_cfg, ts, traj),
                                          replay.add_episodes(rep, traj)))

    # the graph of UPDATE_CHUNK updates for this generator is captured
    # untimed, by one chunk
    trainer.run_updates(rl_cfg, ts, rep, g, trainer.UPDATE_CHUNK)
    _, t_update = timed(lambda: trainer.run_updates(rl_cfg, ts, rep, g, 200))
    print(f"[breakdown] collect {t_collect:.3f} s (the first with this generator: its "
          f"capture included), normalizers + replay insert {t_observe:.3f} s, 200 updates "
          f"{t_update:.3f} s (graph replays)")


def _lockstep_module():
    """scripts/torch_lockstep.py of this checkout, as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_lockstep.py")
    spec = importlib.util.spec_from_file_location("torch_lockstep", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_lockstep(dev, smi):
    """Run 918 on the card in lockstep with the JAX package's CPU run of
    scripts/lockstep_918.npz; returns the kernels' launches on this path."""
    import numpy as np

    L = _lockstep_module()
    with np.load(L.NPZ) as d:
        ref = {k: d[k] for k in d.files}
    meta = json.loads(str(ref["meta"]))
    check(any(k.startswith("cpu/") for k in ref), f"{L.NPZ} holds no CPU float32 yardstick")
    argv = meta["argv"] + ["--seed", str(meta["weights_seed"])]
    _reset_launches()
    arrays, env, seconds = L.torch_run(argv, L.weights_918(meta["weights_seed"]), device=dev,
                                       **L.run_kwargs(meta))
    launches = _launches()
    got = L.strip(arrays, "torch")
    report = L.compare_918(got, ref)
    s = report["summary"]
    T = env.episode_length
    print(f"[lockstep] ({smi}) run 918 at full width, {meta['generations']} generations "
          f"(weights seed {meta['weights_seed']}, tape seed {meta['tape_seed']}, "
          f"{meta['dtype']}) eagerly on the card in {seconds:.1f} s; launches {launches}; "
          f"draws {s['draws']} (card, JAX); generator unmoved {s['generator_unmoved']}")
    print(f"[lockstep] generations 1-4 against JAX: worst gap {s['collect_worst']:.3e} "
          f"({s['collect_worst_key']}; tolerance {s['collect_tol']:g}); "
          + ", ".join(f"{k} {v:.3e}" for k, v in report["fill"].items()))
    print(f"[lockstep] generation 5: returns {got['gen/mean_return'].tolist()} (card), "
          f"{ref['jax/gen/mean_return'].tolist()} (JAX), updates {got['gen/n_upd'].tolist()}; "
          f"gaps {json.dumps(s['gen5'])}; final state worst {s['final_worst']:.3e} "
          f"({s['final_worst_key']})")
    yard = report["yardstick"]
    every = 10
    print(f"[lockstep] update-by-update gap (largest gap of its loss terms), every "
          f"{every}th of the first {len(report['per_update'])}: card "
          + " ".join(f"{x:.1e}" for x in report["per_update"][::every])
          + "; CPU float32 " + " ".join(f"{x:.1e}" for x in yard[::every]))
    print(f"[lockstep] first {s['first_updates']} updates worst {s['first_updates_worst']:.3e} "
          f"(tolerance {s['first_updates_tol']:g}); first update where the card's gap exceeds "
          f"10x the CPU's: {s['first_update_over_10x_cpu']}")
    check(launches["abcn_macro_step"] == meta["generations"] * T,
          f"lockstep: abcn launched {launches['abcn_macro_step']} times")
    check(launches["mlp_forward"] >= meta["generations"] * T,
          f"lockstep: mlp launched {launches['mlp_forward']} times")
    check(s["ok"], f"lockstep: the card parts from the JAX package's run: {json.dumps(s)}")
    return launches


def phase_f2(dev):
    """Fault F2's op on the card against the CPU: the policy's log-probability
    takes both tails of the clipped normal through ``distributions.log_ndtr``
    (JAX's value and derivative rule).  Over a float32 sweep of |z| from 1e-3
    to 1e7 (the card's two first non-finite arguments included), its value on
    the card agrees with the CPU's within F2_TOL relative, its derivative too
    where |z| <= 10, and a zero cotangent (an unselected tail) gives exactly
    0 on the card everywhere.  torch.special.log_ndtr's zero-cotangent
    backward, which F2 went through, is counted beside it."""
    import numpy as np
    import torch
    from marlpde_tpu_torch.rl import distributions as D

    z = np.concatenate([-np.logspace(-3, 7, 20001), np.logspace(-3, 7, 20001),
                        F2_ARGS]).astype(np.float32)
    out = {}
    for where in ("cpu", dev):
        grads = []
        for fn, cot in ((D.log_ndtr, 1.0), (D.log_ndtr, 0.0), (torch.special.log_ndtr, 0.0)):
            x = torch.tensor(z, device=where, requires_grad=True)
            y = fn(x)
            y.backward(torch.full_like(y, cot))
            grads.append(x.grad.cpu().numpy())
        out[where] = (y.detach().cpu().numpy(), *grads)
    (yc, gc, _, _), (yd, gd, zero_d, torch_d) = out["cpu"], out[dev]
    # values under 1e-12 (far in the upper tail) are held to 1e-17 absolute
    val_rel = np.max(np.abs(yd - yc) / np.maximum(np.abs(yc), 1e-12))
    mid = np.abs(z) <= 10
    der_rel = np.max(np.abs(gd[mid] - gc[mid]) / np.maximum(np.abs(gc[mid]), 1e-30))
    print(f"[f2] log_ndtr over {len(z)} float32 arguments, |z| 1e-3..1e7, on the card against "
          f"the CPU: value max rel {val_rel:.3g}, derivative (|z| <= 10) max rel {der_rel:.3g} "
          f"(tolerance {F2_TOL}); card: derivative finite at {np.isfinite(gd).sum()} of "
          f"{len(z)}, a zero cotangent gives {np.count_nonzero(zero_d)} non-zero; "
          f"torch.special.log_ndtr's zero-cotangent backward non-finite at "
          f"{np.count_nonzero(~np.isfinite(torch_d))} (at the card's F2 arguments "
          f"{F2_ARGS}: {torch_d[-len(F2_ARGS):].tolist()})", flush=True)
    check(np.isfinite(yd).all() and np.isfinite(gd).all() and not np.count_nonzero(zero_d),
          "f2: log_ndtr's value or derivative is not finite on the card, or a zero "
          "cotangent gave a non-zero gradient")
    check(val_rel <= F2_TOL and der_rel <= F2_TOL,
          f"f2: log_ndtr on the card differs from the CPU: {val_rel}, {der_rel}")


def phase_small_agreement(dev):
    """A small deterministic collection through the kernels on the card against
    the same collection through the plain versions on the CPU."""
    import torch
    from marlpde_tpu_torch.envs import registry, rollout
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.rl import vracer

    kw = dict(N_dns=64, grid_size=32, num_actions=32, num_agents=4, dt=0.01, T=0.5,
              nu=0.05, episode_length=5, ic_case="turbulence", spectral_reward=True)
    trajs, weights = {}, None
    for d in ("cpu", dev):
        env = registry.make_env("burger", device=d, **kw)
        rl_cfg = trainer.default_rl_config(env, width=128)
        ts = vracer.init_train(rl_cfg, torch.Generator(device=d).manual_seed(3), device=d)
        if weights is None:
            weights = ts.net.state_dict()
        ts.net.load_state_dict(weights)         # the CPU net's weights on both sides
        trajs[d] = rollout.collect_episodes(env, rl_cfg, ts, None, 6, deterministic=True)[0]
    worst = 0.0
    for name in ("obs", "actions", "rewards", "mask"):
        a, b = trajs[dev][name].cpu(), trajs["cpu"][name]
        check(a.shape == b.shape and torch.isfinite(a).all(), f"small {name}")
        worst = max(worst, ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item())
    print(f"[small] deterministic collection, card vs CPU: max err {worst:.3e} relative "
          f"to each tensor's max |value| (tolerance 1e-4: float32 kernels against the "
          f"CPU's plain versions over 5 macro-steps)")
    check(worst <= 1e-4, f"card and CPU collections disagree: {worst:.3e}")


def _same(a, b):
    """Whether two tensors hold the same bits, NaN where NaN; and the
    largest difference where both are finite."""
    import torch
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    if not a.is_floating_point():
        return torch.equal(a, b), 0.0
    both_nan = torch.isnan(a) & torch.isnan(b)
    same = bool(((a == b) | both_nan).all())
    fin = torch.isfinite(a) & torch.isfinite(b)
    diff = (a - b).abs()[fin].max().item() if fin.any() else 0.0
    return same, diff


def _profiled(fn):
    """(wall seconds, device busy seconds, host launches by runtime call, the
    mean host µs of one cudaLaunchKernel call, the profiler's own seconds) of
    ``fn`` under torch.profiler (device activity only: kernels and the
    runtime calls), synchronized at both ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    events = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                    for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    calls = {e.key: e.count for e in events
             if e.key.startswith("cu") and ("Launch" in e.key or "Memcpy" in e.key
                                           or "Memset" in e.key)}
    launch_us = [e.cpu_time_total / e.count for e in events if e.key == "cudaLaunchKernel"]
    return (wall, device_us / 1e6, calls, launch_us[0] if launch_us else float("nan"),
            time.perf_counter() - t0 - wall)


def _graphs_generation(env, rl_cfg, ts, rep, g, B, base, eager):
    """One generation (collection, normalizers + insert, GRAPH_UPDATES
    updates) through the graphs, or, with ``eager``, the step functions
    called directly: (ts, traj, final state, collection s, ms per update, the
    kernels' launches in the collection and in the updates), timed with CUDA
    events."""
    import torch
    from marlpde_tpu_torch.envs import rollout
    from marlpde_tpu_torch.kernels import abcn, mlp
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.utils import graphs

    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    counts = []
    with graphs.eager() if eager else contextlib.nullcontext():
        counts.append((abcn.launches, mlp.launches))
        events[0].record()
        traj, final = rollout.collect_episodes(env, rl_cfg, ts, g, B, base)
        events[1].record()
        counts.append((abcn.launches, mlp.launches))
        ts, rep = trainer.insert_generation(rl_cfg, ts, rep, traj)
        counts.append((abcn.launches, mlp.launches))
        events[2].record()
        trainer.run_updates(rl_cfg, ts, rep, g, GRAPH_UPDATES)
        events[3].record()
        counts.append((abcn.launches, mlp.launches))
    events[3].synchronize()
    d = lambda i: tuple(b - a for a, b in zip(counts[i], counts[i + 1]))
    return (ts, traj, final, events[0].elapsed_time(events[1]) / 1e3,
            events[2].elapsed_time(events[3]) / GRAPH_UPDATES, d(0), d(2))


# [graphs]' paths: the steps called directly, the updates replayed one to a
# graph, and UPDATE_CHUNK (50) to a graph, as the trainer runs them
GRAPH_PATHS = (("eager", 1), ("graphs-1", 1), ("graphs-50", 50))


@contextlib.contextmanager
def _update_chunk(k):
    """``trainer.run_updates`` with ``k`` updates a graph inside the block."""
    from marlpde_tpu_torch.train import trainer
    real = trainer.UPDATE_CHUNK
    trainer.UPDATE_CHUNK = k
    try:
        yield
    finally:
        trainer.UPDATE_CHUNK = real


def _capture_beside_garbage(dev):
    """A step that drops an old graph into a reference cycle and then makes
    the allocations that start a collection, captured with the collector at
    a threshold of one: the old graph is freed after the capture, not inside
    it, where its destruction would invalidate the capture."""
    import gc

    import torch
    from marlpde_tpu_torch.utils import graphs

    x = torch.zeros(1024, device=dev)

    def step():
        x.add_(1.0)

    old = [graphs.capture("old step", step, dev)[1] for _ in range(2)]

    def dropping():
        step()
        cycle = {"graph": old.pop()}
        cycle["self"] = cycle
        del cycle
        _ = [[i] for i in range(1000)]
        step()

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        graph = graphs.capture("step dropping an old graph", dropping, dev)[1]
    finally:
        gc.set_threshold(*thresholds)
    graph.replay()
    torch.cuda.synchronize()
    check(x[0].item() == 6.0, f"[graphs] the step beside garbage: {x[0].item()}")
    print("[graphs] a capture whose step drops an old graph into a reference cycle, the "
          "collector at threshold 1: captured and replayed")


def phase_graphs(env_flagship, workdir):
    """The training path's CUDA graphs against the step functions called
    directly, on the card: for run-918 (experience mode, both kernels), the
    fused flagship (episode mode, 1024 envs), run-926 KS and run-927
    burger-fd, two generations from one state (after an eager collection
    and insert), each path of GRAPH_PATHS (eager, one update a graph, 50 a
    graph) on its own copy of the train state, replay and generator.  Then
    a graphed resume through the CLI."""
    import copy
    import torch
    from marlpde_tpu_torch import run
    from marlpde_tpu_torch.envs import ks_env, rollout
    from marlpde_tpu_torch.rl import vracer
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.utils import graphs

    _capture_beside_garbage(env_flagship.device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    configs = []
    for label, argv in (("run-918", RUN_918), ("run-926", RUN_926), ("run-927", RUN_927)):
        pools, restore = _timed_pools(ks_env) if label == "run-926" else ({}, lambda: None)
        try:
            env, rl_cfg, tc = run.make_workload(run.build_parser().parse_args(argv))
        finally:
            restore()
        configs.append((label, env, rl_cfg, tc.num_envs))
    configs.insert(1, ("fused flagship", env_flagship,
                       trainer.default_rl_config(env_flagship, width=128), NUM_ENVS))
    failures = []
    for label, env, rl_cfg, B in configs:
        t_config = time.perf_counter()
        dev = env.device
        g0 = torch.Generator(device=dev).manual_seed(11)
        ts = vracer.init_train(rl_cfg, g0, device=dev)
        rep = trainer.make_replay(env, rl_cfg)
        with graphs.eager():
            traj, _ = rollout.collect_episodes(env, rl_cfg, ts, g0, B, 0)
            ts, rep = trainer.insert_generation(rl_cfg, ts, rep, traj)
        runs = {}
        for path, chunk in GRAPH_PATHS:
            t, r = copy.deepcopy(ts), graphs.clone(rep)
            g = torch.Generator(device=dev)
            g.set_state(g0.get_state())
            gens = []
            with _update_chunk(chunk):
                for k in (1, 2):
                    t, traj, final, col_s, upd_ms, col_n, upd_n = _graphs_generation(
                        env, rl_cfg, t, r, g, B, k * B, eager=path == "eager")
                    gens.append((traj, final, col_s, upd_ms, col_n, upd_n))
            runs[path] = (t, r, g, gens)
        te, re_, ge, gens_e = runs["eager"]
        (_, _, col_e, upd_e, coln_e, updn_e) = gens_e[1]
        T = env.episode_length
        upd_ms = {}
        for path, chunk in GRAPH_PATHS[1:]:
            tg, rg, gg, gens_g = runs[path]
            pairs = []
            for (tr_e, fin_e, *_), (tr_g, fin_g, *_) in zip(gens_e, gens_g):
                pairs += [(f"traj.{k}", tr_e[k], tr_g[k]) for k in tr_e]
                pairs += [(f"final.{i}", a, b) for i, (a, b) in enumerate(
                    zip(graphs.tensors(fin_e), graphs.tensors(fin_g)))]
            pairs += [(f"param.{n}", p, q) for (n, p), q in zip(te.net.named_parameters(),
                                                                tg.net.parameters())]
            for i, (a, b) in enumerate(zip(list(te.opt.state.values()),
                                           list(tg.opt.state.values()))):
                pairs += [(f"adam.{i}.{k}", a[k], b[k]) for k in a]
            pairs += [("beta", te.beta, tg.beta), ("n_updates", te.n_updates, tg.n_updates),
                      ("generator", ge.get_state(), gg.get_state())]
            pairs += [(f"replay.{f.name}", getattr(re_, f.name), getattr(rg, f.name))
                      for f in dataclasses.fields(rep)
                      if isinstance(getattr(re_, f.name), torch.Tensor)]
            pairs += [(f"stats.{i}", a, b) for i, (a, b) in enumerate(zip(
                graphs.tensors((te.obs_stats, te.rew_stats)),
                graphs.tensors((tg.obs_stats, tg.rew_stats))))]
            verdict = [(name, *_same(a, b)) for name, a, b in pairs]
            differ = [(name, diff) for name, same, diff in verdict if not same]
            (_, _, col_g, upd_g, coln_g, updn_g) = gens_g[1]
            upd_ms[path] = upd_g
            print(f"[graphs] {label} ({smi}): 2 generations of {B} envs x {T} macro-steps and "
                  f"{GRAPH_UPDATES} {rl_cfg.minibatch_mode}-mode updates from one state, "
                  f"{path} ({chunk} update{'s' * (chunk > 1)} a graph) against eager: "
                  f"{len(verdict) - len(differ)} of {len(verdict)} tensors bitwise equal "
                  f"(trajectories, final states, parameters, Adam moments and steps, beta, "
                  f"the counter, the generator, every replay buffer incl. sv, vtg, rho)"
                  + (f"; differ: {differ}" if differ else ""), flush=True)
            check(coln_g == coln_e and updn_g == updn_e,
                  f"graphs {label} {path}: launches counted per replay {coln_g} {updn_g} "
                  f"against eager {coln_e} {updn_e}")
            if differ:
                failures.append((label, path, differ))
        col_g = runs["graphs-50"][3][1][2]
        print(f"[graphs] {label} generation 2: collection {col_g:.4f} s graphed, {col_e:.4f} s "
              f"eager ({col_e / col_g:.2f}x); ms per update {upd_ms['graphs-50']:.4f} with 50 "
              f"updates a graph, {upd_ms['graphs-1']:.4f} with one a graph, {upd_e:.4f} eager "
              f"({upd_ms['graphs-1'] / upd_ms['graphs-50']:.2f}x, "
              f"{upd_e / upd_ms['graphs-50']:.2f}x) (CUDA events); kernel launches "
              f"abcn/mlp: collection {coln_e}, updates {updn_e} on every path", flush=True)
        # host launches and device busy share under graphs: one more collection
        # and PROFILED_UPDATES updates on each graphed path; the eager update's
        # launches for comparison
        n = PROFILED_UPDATES
        t, r, g, _ = runs["graphs-50"]
        wall_c, busy_c, calls_c, _, over = _profiled(
            lambda: rollout.collect_episodes(env, rl_cfg, t, g, B, 3 * B))
        profiled = {}
        for path, chunk in GRAPH_PATHS[1:]:
            t, r, g, _ = runs[path]
            with _update_chunk(chunk):
                profiled[path] = _profiled(lambda: trainer.run_updates(rl_cfg, t, r, g, n))
            over += profiled[path][4]
        t, r, g, _ = runs["eager"]
        with graphs.eager():
            _, _, calls_e, launch_us, over_e = _profiled(
                lambda: trainer.run_updates(rl_cfg, t, r, g, n))
        host_us = 1e3 * upd_e / (sum(calls_e.values()) / n)
        per = lambda calls, k: {name: round(v / k, 2) for name, v in sorted(calls.items())}
        (wall_50, busy_50, calls_50, _, _), (wall_1, busy_1, calls_1, _, _) = (
            profiled["graphs-50"], profiled["graphs-1"])
        print(f"[graphs] {label} under torch.profiler: host launches per macro-step graphed "
              f"{per(calls_c, T)}, per update with 50 updates a graph {per(calls_50, n)}, one "
              f"a graph {per(calls_1, n)}, eager {per(calls_e, n)}; device busy under graphs "
              f"{100 * busy_c / wall_c:.1f}% of the collection ({wall_c:.4f} s), "
              f"{100 * busy_50 / wall_50:.1f}% of {n} updates 50 a graph "
              f"({1e3 * wall_50 / n:.4f} ms each), {100 * busy_1 / wall_1:.1f}% one a graph "
              f"({1e3 * wall_1 / n:.4f} ms each); eager, {host_us:.2f} µs of an update's "
              f"time per host launch, {launch_us:.2f} µs of it in the cudaLaunchKernel call "
              f"itself (the rest Python and PyTorch's dispatch); the profiler's own "
              f"{over + over_e:.1f} s", flush=True)
        graph_launches = lambda calls: sum(v for k, v in calls.items() if "GraphLaunch" in k)
        check(graph_launches(calls_c) == T and graph_launches(calls_1) == n
              and graph_launches(calls_50) == -(-n // 50),
              f"graphs {label}: graph launches {calls_c} {calls_1} {calls_50}")
        del runs
        print(f"[graphs] {label}: {time.perf_counter() - t_config:.1f} s", flush=True)
    _graphs_resume(workdir)
    check(not failures, f"graphs against eager differ: {failures}")


def _graphs_resume(workdir):
    """Two graphed generations of the run-918 CLI straight, against one
    generation, a checkpoint (with the replay), --resume and one more: the
    same train state and replay, bit for bit."""
    import torch
    from marlpde_tpu_torch.utils import graphs

    flags = RUN_918 + "--rstart 2000 --maxupd 100 --serialize-replay".split()
    ts_a, rep_a, hist_a, _, _ = _cli(flags + ["--NE", "10000", "--run", "95"], "graphs-straight")
    _cli(flags + ["--NE", "5000", "--run", "96"], "graphs-first")
    ts_b, rep_b, hist_b, _, _ = _cli(flags + ["--NE", "10000", "--run", "96", "--resume"],
                                     "graphs-resumed")
    check(hist_a["updates"] == hist_b["updates"] == [100, 100],
          f"graphs resume: updates {hist_a['updates']} {hist_b['updates']}")
    pairs = [(f"param.{n}", p, q) for (n, p), q in zip(ts_a.net.named_parameters(),
                                                         ts_b.net.parameters())]
    for i, (a, b) in enumerate(zip(ts_a.opt.state.values(), ts_b.opt.state.values())):
        pairs += [(f"adam.{i}.{k}", a[k], b[k]) for k in a]
    pairs += [("beta", ts_a.beta, ts_b.beta), ("n_updates", ts_a.n_updates, ts_b.n_updates)]
    pairs += [(f"replay.{k}", a, b) for k, a, b in zip(
        [f.name for f in dataclasses.fields(rep_a)], graphs.tensors(rep_a), graphs.tensors(rep_b))]
    differ = [(name, diff) for name, a, b in pairs for same, diff in [_same(a, b)] if not same]
    print(f"[graphs] resume: run-918 flags (--rstart 2000 --maxupd 100 --serialize-replay), 2 "
          f"generations straight against 1 + checkpoint + --resume + 1: "
          f"{len(pairs) - len(differ)} of {len(pairs)} tensors bitwise equal (parameters, Adam, "
          f"beta, the counter, the replay); returns {hist_a['mean_return']} against "
          f"{hist_b['mean_return']}" + (f"; differ: {differ}" if differ else ""), flush=True)
    check(not differ and hist_a["mean_return"] == hist_b["mean_return"],
          f"graphs resume differs: {differ}")


def _cli(argv, tag, also=None):
    """``marlpde_tpu_torch.run.main(argv)`` with its standard output captured:
    returns (ts, rep, history, per-generation rows, captured lines).  Each
    row holds the generation's seconds and kernel launches.  ``also(gen, ts,
    rep, hist)`` runs after each generation."""
    import torch
    from marlpde_tpu_torch import run
    from marlpde_tpu_torch.kernels import abcn, mlp

    rows = []

    def report(gen, ts, rep, hist):
        torch.cuda.synchronize()
        rows.append(dict(gen=gen, wall=hist["wall_time"][-1], abcn=abcn.launches,
                         mlp=mlp.launches))
        if also is not None:
            also(gen, ts, rep, hist)

    buf = io.StringIO()
    _reset_launches()
    with contextlib.redirect_stdout(buf):
        ts, rep, hist = run.main(argv, callback=report)
    lines = buf.getvalue().splitlines()
    prev = dict(wall=0.0, abcn=0, mlp=0)
    for r in rows:
        r["s"] = r["wall"] - prev["wall"]
        r["d_abcn"], r["d_mlp"] = r["abcn"] - prev["abcn"], r["mlp"] - prev["mlp"]
        prev = r
    for ln in lines:
        print(f"[{tag}] | {ln}")
    json_lines = [ln for ln in lines if ln.startswith("{")]
    check(len(json_lines) == 1, f"{tag}: the CLI printed {len(json_lines)} JSON lines")
    out = json.loads(json_lines[0])
    check(out["workload"] == argv[0] and out["generations"] == hist["gen"][-1]
          and out["final_mean_return"] == hist["mean_return"][-1], f"{tag}: JSON line {out}")
    return ts, rep, hist, rows, _launches()


def _check_generations(tag, hist, rows, first_gen, abcn=True):
    """Each generation's line, and its checks: finite returns and metrics,
    metrics exactly where updates ran, 500 or more MLP launches, and 500 or
    more ABCN launches on the flagship's paths (``abcn``), none elsewhere."""
    import numpy as np
    for r in rows:
        i = r["gen"] - 1
        m = hist["metrics"][i]
        print(f"[{tag}] gen {r['gen']}: {r['s']:.3f} s, updates {hist['updates'][i]}, "
              f"mean_return {hist['mean_return'][i]:.6f}, blowups {hist['blowups'][i]}, "
              f"ep_len {hist['mean_ep_len'][i]:.1f}, launches abcn +{r['d_abcn']} "
              f"mlp +{r['d_mlp']}, beta {m.get('beta', '-')}", flush=True)
        check((r["d_abcn"] >= 500 if abcn else r["d_abcn"] == 0) and r["d_mlp"] >= 500,
              f"{tag} gen {r['gen']}: kernels launched abcn {r['d_abcn']}, mlp {r['d_mlp']}")
        check(np.isfinite(hist["mean_return"][i]), f"{tag} gen {r['gen']}: return")
        check(all(np.isfinite(v) for v in m.values()), f"{tag}: metrics not finite: {m}")
        check(bool(m) == (hist["updates"][i] > 0), f"{tag} gen {r['gen']}: metrics {m}")
    check(rows[0]["gen"] == first_gen, f"{tag}: first generation {rows[0]['gen']}")


def _check_state_on_card(tag, ts, rep):
    import torch
    check(all(p.is_cuda and torch.isfinite(p).all() for p in ts.net.parameters()),
          f"{tag}: params not finite or not on the card")
    check(ts.beta.is_cuda and rep.obs.is_cuda and rep.vtg.is_cuda and rep.ep_last.is_cuda,
          f"{tag}: train state or replay not on the card")


def _check_best(tag, res, hist):
    """best/ holds the policy of the best test return, from a generation
    that ran updates, so that --test --best reads a trained policy."""
    best = os.path.join(res, "best")
    check(all(os.path.exists(os.path.join(best, f)) for f in ("latest.pt", "best.json")),
          f"{tag}: best/ checkpoint missing")
    with open(os.path.join(best, "best.json")) as f:
        best_json = json.load(f)
    check(best_json["test_return"] == max(hist["test_return"])
          and hist["updates"][best_json["gen"] - 1] > 0, f"{tag} best.json {best_json}")
    return best_json


def phase_cli(workdir):
    """The run-918 flagship through the CLI: 5 generations tested after the
    fifth, the first with updates, then --resume for a sixth."""
    import numpy as np
    import torch

    ts, rep, hist, rows, launches = _cli(RUN_918 + ["--NE", "25000", "--testfreq", "5"], "cli")
    _check_generations("cli", hist, rows, 1)
    print(f"[cli] loss head launches {launches['vracer_loss']} over {sum(hist['updates'])} "
          f"updates")
    check(launches["experience_updates"] == sum(hist["updates"]) == 2500
          and launches["vracer_loss"] == HEAD_LAUNCHES * 2500, f"cli: launches {launches}")
    # korali ledger: rstart 20000, expperu 0.5, cap 2500, 5000 live steps a generation
    check(hist["updates"] == [0, 0, 0, 0, 2500], f"cli updates {hist['updates']}")
    check(ts.n_updates == 2500, f"cli n_updates {int(ts.n_updates)}")
    check(hist["blowups"][0] == 0, f"cli generation 1 had {hist['blowups'][0]} blowups")
    check(len(hist["test_return"]) == 1 and np.isfinite(hist["test_return"]).all(),
          f"cli test returns {hist['test_return']}")
    res = os.path.join(workdir, "_result_burger-marl_0")
    best_json = _check_best("cli", res, hist)
    diag_keys = {"v0_scaled", "return_scaled", "rew_scale", "mu_drift_rms",
                 "mu_from_init_rms", "mu_rms", "sigma_probe", "replay_occupancy"}
    check(len(hist["diag"]) == 5 and all(set(d) == diag_keys for d in hist["diag"]),
          "cli: diag rows")
    check(all(os.path.exists(os.path.join(res, f))
              for f in ("latest.pt", "history.json", "meta.npz")), "cli: checkpoint missing")
    _check_state_on_card("cli", ts, rep)
    print(f"[cli] test returns {hist['test_return']}, best {best_json}, "
          f"last diag {json.dumps(hist['diag'][-1])}")
    print(f"[cli] last update metrics: {json.dumps(hist['metrics'][-1])}")

    ts, rep, hist, rows2, launches2 = _cli(
        RUN_918 + ["--NE", "30000", "--testfreq", "2", "--resume"], "cli-resume")
    _check_generations("cli-resume", hist, rows2, 6)
    check(hist["gen"] == list(range(1, 7)) and hist["updates"][5] == 2500,
          f"cli resume: gens {hist['gen']} updates {hist['updates']}")
    check(ts.n_updates == 5000, f"cli resume n_updates {int(ts.n_updates)}")
    _check_state_on_card("cli-resume", ts, rep)
    total = {k: launches[k] + launches2[k] for k in launches}
    return ts, rep, total


def phase_cli_breakdown(tag, argv, ts, rep, what, gen_updates, gen_s=None):
    """One CLI generation's phases on the card, each ended by a sync: the
    collection of ``argv``'s episodes, normalizers + flat insert, and
    BREAKDOWN_UPDATES experience-mode updates; the collection's share is of a
    generation with ``gen_updates`` updates at the measured ms per update."""
    import torch
    from marlpde_tpu_torch import run
    from marlpde_tpu_torch.envs import rollout
    from marlpde_tpu_torch.train import trainer

    env, rl_cfg, tc = run.make_workload(run.build_parser().parse_args(argv))
    g = torch.Generator(device=ts.beta.device).manual_seed(7)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the collection's and the updates' graphs for this env and generator are
    # captured untimed, by one collection and one chunk of updates
    rollout.collect_episodes(env, rl_cfg, ts, g, tc.num_envs, 6 * tc.num_envs)
    (traj, _), t_collect = timed(lambda: rollout.collect_episodes(
        env, rl_cfg, ts, g, tc.num_envs, 7 * tc.num_envs))
    (ts, rep), t_insert = timed(lambda: trainer.insert_generation(rl_cfg, ts, rep, traj))
    trainer.run_updates(rl_cfg, ts, rep, g, trainer.UPDATE_CHUNK)
    _, t_update = timed(lambda: trainer.run_updates(rl_cfg, ts, rep, g, BREAKDOWN_UPDATES))
    per_update = t_update / BREAKDOWN_UPDATES
    share = t_collect / (t_collect + t_insert + gen_updates * per_update)
    line = (f"[{tag}] collect ({what}) {t_collect:.3f} s, normalizers + flat insert "
            f"{t_insert:.3f} s, {BREAKDOWN_UPDATES} updates {t_update:.3f} s "
            f"({1000 * per_update:.3f} ms per update at mbsize {rl_cfg.mini_batch_size}); "
            f"collection {100 * share:.1f}% of a generation with {gen_updates} updates")
    if gen_s:
        line += f"; the CLI's generations took {', '.join(f'{x:.3f}' for x in gen_s)} s"
    print(line)
    return 1000 * per_update


def phase_cli_w256():
    """One generation at the CLI's default width (256): the kernel's streamed
    W2 on the main path."""
    ts, rep, hist, rows, launches = _cli(
        "burger-marl --nagents 32 --specreward --dforce --ic turbulence --NE 5000 "
        "--numenvs 10 --run 256".split(), "cli-w256")
    _check_generations("cli-w256", hist, rows, 1)
    check(ts.net.width == 256 and hist["gen"] == [1] and hist["blowups"][0] == 0,
          f"cli-w256: width {ts.net.width}, gens {hist['gen']}")
    _check_state_on_card("cli-w256", ts, rep)
    return launches


def phase_fast_off(dev):
    """A deterministic collection at flagship widths, B=64 and 20 macro-steps
    of 10 sub-steps, through fast='off' (per-env env, torch.fft solver) and
    fast='auto' (whole-batch env, ABCN kernel), with the same weights."""
    import torch
    from marlpde_tpu_torch.envs import registry, rollout
    from marlpde_tpu_torch.kernels import abcn
    from marlpde_tpu_torch.rl import vracer
    from marlpde_tpu_torch.train import trainer

    kw = dict(FLAGSHIP, T=0.2, episode_length=20)
    trajs, weights = {}, None
    for fast in ("off", "auto"):
        env = registry.make_env("burger", device=dev, fast=fast, **kw)
        check(env.whole_batch == (fast == "auto"), f"fast={fast} env")
        rl_cfg = trainer.default_rl_config(env, width=128)
        ts = vracer.init_train(rl_cfg, torch.Generator(device=dev).manual_seed(5), device=dev)
        if weights is None:
            weights = ts.net.state_dict()
        ts.net.load_state_dict(weights)
        before = abcn.launches
        trajs[fast] = rollout.collect_episodes(env, rl_cfg, ts, None, 64, deterministic=True)[0]
        torch.cuda.synchronize()
        check((abcn.launches - before) == (20 if fast == "auto" else 0),
              f"fast={fast}: abcn launches {abcn.launches - before}")
    worst = {}
    for name in ("obs", "actions", "mu", "sigma", "rewards", "mask", "final_obs"):
        a, b = trajs["off"][name], trajs["auto"][name]
        check(a.shape == b.shape and torch.isfinite(a).all(), f"fast-off {name}")
        worst[name] = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
    check(torch.equal(trajs["off"]["truncated"], trajs["auto"]["truncated"]), "truncated flags")
    print(f"[fast-off] B=64, 20 macro-steps x 10 sub-steps, N_dns 512, 32 agents: max err "
          f"relative to each tensor's max |value| {json.dumps(worst)} (tolerance "
          f"{FAST_OFF_TOL:g}: float32 torch.fft against the kernel's radix-2 FFTs)")
    check(max(worst.values()) <= FAST_OFF_TOL, f"fast='off' and 'auto' disagree: {worst}")


def _main_json(argv, tag):
    """``run.main(argv)`` with its standard output captured and echoed: returns
    (what main returns, the one JSON line it printed, the kernel launches)."""
    from marlpde_tpu_torch import run
    import torch

    buf = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = run.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print(f"[{tag}] | {ln}")
    json_lines = [json.loads(ln) for ln in lines if ln.startswith("{")]
    check(len(json_lines) == 1, f"{tag}: the CLI printed {len(json_lines)} JSON lines")
    return out, json_lines[0], seconds, _launches()


def _finite(values):
    import numpy as np
    return bool(np.isfinite(np.asarray(values, dtype=float)).all())


def phase_cli_test(workdir):
    """The run-918 flags with --test, then --test --best, on the [cli]
    phase's checkpoints in ``workdir`` (scripts/tpu_flagship_918.sh:24-29)."""
    import numpy as np

    res = os.path.join(workdir, "_result_burger-marl_0")
    total = _no_launches()
    for extra in ([], ["--best"]):
        tag = "cli-test" + ("-best" if extra else "")
        summary, line, seconds, launches = _main_json(RUN_918 + ["--test"] + extra, tag)
        check(line == summary, f"{tag}: printed {line}, returned {summary}")
        # the JAX CLI's keys (marlpde_tpu/run.py:527-569)
        check(list(summary) == ["workload", "test_mean_return", "test_returns", "nus",
                                "baseline_cumreward", "controlled_cumreward"],
              f"{tag}: summary keys {list(summary)}")
        check(len(summary["test_returns"]) == 8 and summary["nus"] == []
              and _finite([summary["test_mean_return"], summary["baseline_cumreward"],
                           summary["controlled_cumreward"]] + summary["test_returns"]),
              f"{tag}: summary {summary}")
        shapes = {f: np.load(os.path.join(res, f"{f}_0.npy")).shape
                  for f in ("relError", "sgsTerms", "dnsSgsTerms")}
        check(shapes == dict(relError=(1, 500), sgsTerms=(1, 500, 32),
                             dnsSgsTerms=(1, 5001, 32)), f"{tag}: dumps {shapes}")
        figures = [f for f in ("test.png", "test_panels.npz")
                   if os.path.exists(os.path.join(res, f))]
        check(figures, f"{tag}: neither the figures nor test_panels.npz")
        # evaluate: 500 ABCN launches (B=8) and 500 MLP; the pool sweep and the
        # comparison step the per-env env, 500 MLP launches each
        check(launches == dict(_no_launches(), abcn_macro_step=500, mlp_forward=1500),
              f"{tag}: launches {launches}")
        total = {k: total[k] + launches[k] for k in total}
        print(f"[{tag}] {seconds:.3f} s; test_mean_return {summary['test_mean_return']:.6f}, "
              f"controlled {summary['controlled_cumreward']:.6f} against uncontrolled "
              f"{summary['baseline_cumreward']:.6f}; dumps {shapes}; {figures[0]}; "
              f"launches {launches}")
    return total


def phase_ks(workdir):
    """The run-926 KS flags through the CLI, cut to 3 generations of 16
    episodes (--NE 24000) tested after the third, the first with updates,
    then --test and --test --best
    (scripts/tpu_ks_926.sh)."""
    import numpy as np
    import torch
    from marlpde_tpu_torch.envs import ks_env

    pools, restore = _timed_pools(ks_env)
    try:
        ts, rep, hist, rows, launches = _cli(RUN_926 + ["--NE", "24000", "--testfreq", "3"],
                                             "ks")
    finally:
        restore()
    shape, where, build_s = pools[0]
    check(shape == (16, 2001, 1024) and where == "cuda", f"ks: DNS pool {shape} on {where}")
    print(f"[ks] host DNS pool (16 rows of N=1024, 200 + 2000 ETDRK4 steps each, float64 "
          f"numpy) built and placed on the card in {build_s:.2f} s")
    for r in rows:
        i = r["gen"] - 1
        print(f"[ks] gen {r['gen']}: {r['s']:.3f} s, updates {hist['updates'][i]}, "
              f"mean_return {hist['mean_return'][i]:.6f}, blowups {hist['blowups'][i]}, "
              f"launches abcn +{r['d_abcn']} mlp +{r['d_mlp']}", flush=True)
    # padded (--fused) accounting: updates_per_generation = min(--maxupd 1000,
    # 16 envs x 500 steps x reuse 512 (mbsize 256 / expperu 0.5) / 256) = 1000;
    # _updates_started waits for 20000 experiences (rstart 20000 x 500 / 500):
    # 8000, 16000, 24000 after generations 1-3
    check(hist["updates"] == [0, 0, 1000], f"ks updates {hist['updates']}")
    check(ts.n_updates == 1000, f"ks n_updates {int(ts.n_updates)}")
    check(hist["blowups"] == [0, 0, 0] and _finite(hist["mean_return"]),
          f"ks blowups {hist['blowups']}, returns {hist['mean_return']}")
    check(len(hist["test_return"]) == 1 and _finite(hist["test_return"]),
          f"ks test returns {hist['test_return']}")
    check(ts.net.width == 256 and ts.net.mu_param == "sigma_relative"
          and ts.net.obs_dim == 32 and ts.net.act_dim == 16, "ks: the learner's shape")
    _check_state_on_card("ks", ts, rep)
    check(launches["mlp_forward"] > 0 and launches["abcn_macro_step"] == 0,
          f"ks: launches {launches}")
    gen_s = [r["s"] for r in rows]
    print(f"[ks] launches {launches}; test returns {hist['test_return']}; last update "
          f"metrics {json.dumps(hist['metrics'][-1])}")

    res = os.path.join(workdir, "_result_ks_926")
    _check_best("ks", res, hist)
    test_launches = _no_launches()
    for extra in ([], ["--best"]):
        tag = "ks-test" + ("-best" if extra else "")
        summary, line, seconds, launches_t = _main_json(RUN_926 + ["--test"] + extra, tag)
        check(list(summary) == ["workload", "test_mean_return", "test_returns", "sample_ids",
                                "baseline_per_id", "controlled_per_id", "baseline_cumreward",
                                "controlled_cumreward"], f"{tag}: keys {list(summary)}")
        check(summary["sample_ids"] == list(range(8)) and len(summary["test_returns"]) == 16
              and all(len(summary[k]) == 8 for k in ("baseline_per_id", "controlled_per_id")),
              f"{tag}: summary {summary}")
        check(_finite(summary["test_returns"] + summary["baseline_per_id"]
                      + summary["controlled_per_id"]), f"{tag}: not finite {summary}")
        missing = [f for i in range(8) for f in (f"sgs_926_s{i}.npz", f"dnsSgs_926_s{i}.npz")
                   if not os.path.exists(os.path.join(res, f))]
        check(not missing, f"{tag}: missing {missing}")
        with np.load(os.path.join(res, "sgs_926_s0.npz")) as d:
            check(d["uu"].shape == (500, 16), f"{tag}: sgs uu {d['uu'].shape}")
        check(launches_t["mlp_forward"] > 0 and launches_t["abcn_macro_step"] == 0,
              f"{tag}: launches {launches_t}")
        test_launches = {k: test_launches[k] + launches_t[k] for k in test_launches}
        print(f"[{tag}] {seconds:.3f} s; controlled {summary['controlled_cumreward']:.6f} "
              f"against uncontrolled {summary['baseline_cumreward']:.6f} over 8 pool rows; "
              f"launches {launches_t}")
    return ts, rep, gen_s, launches, test_launches


def phase_ks_agree(dev):
    """A deterministic KS collection at the run-926 widths (16 envs, N_dns
    1024, grid 16, 16 actions, a width-256 sigma-relative policy), 20
    macro-steps of 4 ETDRK4 sub-steps, on the card and on the CPU with the
    same weights and the same float32 DNS pool."""
    import dataclasses
    import torch
    from marlpde_tpu_torch.envs import ks_env, registry, rollout
    from marlpde_tpu_torch.rl import vracer
    from marlpde_tpu_torch.train import trainer

    kw = dict(N_dns=1024, grid_size=16, num_actions=16, t_end=70.0, episode_length=20)
    pool = ks_env.make_dns_pool(ks_env.KSEnvConfig(**kw), 16, device="cpu")
    pools = {"cpu": pool, dev: ks_env.KSDnsPool(**{
        f.name: getattr(pool, f.name).to(dev) for f in dataclasses.fields(ks_env.KSDnsPool)})}
    trajs, weights = {}, None
    for d in ("cpu", dev):
        env = registry.make_env("ks", pool=pools[d], **kw)
        rl_cfg = trainer.default_rl_config(env, width=256, init_noise=0.01, sigma_max=5.0,
                                           mu_param="sigma_relative")
        ts = vracer.init_train(rl_cfg, torch.Generator(device=d).manual_seed(9), device=d)
        if weights is None:
            with torch.no_grad():       # a non-zero mean head: the actions are not 0
                for p in ts.net.parameters():
                    p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1))
                           * 0.05)
            weights = {k: v.clone() for k, v in ts.net.state_dict().items()}
        ts.net.load_state_dict(weights)
        trajs[d] = rollout.collect_episodes(env, rl_cfg, ts, None, 16, deterministic=True)[0]
    _agree("ks-agree", trajs, dev, KS_AGREE_TOL,
           "B=16, 20 macro-steps x 4 ETDRK4 sub-steps, N_dns 1024, grid 16")


def _timed_pools(module):
    """Patch ``module.make_dns_pool`` to record (shape, device type, seconds)
    of each pool it builds; returns (the list, a function that restores it)."""
    import torch
    pools, build = [], module.make_dns_pool

    def timed_pool(*args, **kw):
        t0 = time.perf_counter()
        pool = build(*args, **kw)
        torch.cuda.synchronize()
        pools.append((tuple(pool.uu.shape), pool.uu.device.type, time.perf_counter() - t0))
        return pool

    module.make_dns_pool = timed_pool
    return pools, lambda: setattr(module, "make_dns_pool", build)


def phase_fd(workdir):
    """The run-927 burger-fd flags through the CLI, cut to 5 generations of 10
    episodes (--NE 25000) tested after the fifth, the first with updates, then
    --test and --test --best."""
    import numpy as np
    from marlpde_tpu_torch.envs import burger_env

    pools, restore = _timed_pools(burger_env)
    try:
        ts, rep, hist, rows, launches = _cli(RUN_927 + ["--NE", "25000", "--testfreq", "5"],
                                             "fd")
    finally:
        restore()
    shape, where, build_s = pools[0]
    check(shape == (1, 5001, 1024) and where == "cuda", f"fd: DNS pool {shape} on {where}")
    print(f"[fd] host DNS pool (1 row of N=1024, 5000 ABCN steps, float64 numpy, with the "
          f"truth channel at the 256-point grid) built and placed on the card in "
          f"{build_s:.2f} s")
    _check_generations("fd", hist, rows, 1, abcn=False)
    # korali ledger: rstart 20000, expperu 0.5, cap 2500, 5000 live steps a generation
    check(hist["updates"] == [0, 0, 0, 0, 2500], f"fd updates {hist['updates']}")
    check(hist["blowups"] == [0] * 5 and hist["mean_ep_len"] == [500.0] * 5,
          f"fd blowups {hist['blowups']}, episode lengths {hist['mean_ep_len']}")
    check(len(hist["test_return"]) == 1 and _finite(hist["test_return"]),
          f"fd test returns {hist['test_return']}")
    check(ts.net.width == 32 and ts.net.obs_dim == 256 and ts.net.act_dim == 256,
          "fd: the learner's shape")
    _check_state_on_card("fd", ts, rep)
    check(launches["mlp_forward"] > 0 and launches["abcn_macro_step"] == 0,
          f"fd: launches {launches}")
    gen_s = [r["s"] for r in rows]
    print(f"[fd] update ledger {hist['updates']}, blowups {hist['blowups']}, launches "
          f"{launches}; test returns {hist['test_return']}; generations "
          f"{', '.join(f'{x:.3f}' for x in gen_s)} s; last update metrics "
          f"{json.dumps(hist['metrics'][-1])}")

    res = os.path.join(workdir, "_result_burger-fd_927")
    _check_best("fd", res, hist)
    test_launches = _no_launches()
    for extra in ([], ["--best"]):
        tag = "fd-test" + ("-best" if extra else "")
        summary, line, seconds, launches_t = _main_json(RUN_927 + ["--test"] + extra, tag)
        check(list(summary) == ["workload", "test_mean_return", "test_returns", "nus",
                                "baseline_cumreward", "controlled_cumreward"],
              f"{tag}: summary keys {list(summary)}")
        check(len(summary["test_returns"]) == 8
              and _finite([summary["baseline_cumreward"], summary["controlled_cumreward"]]
                          + summary["test_returns"]), f"{tag}: summary {summary}")
        shapes = {f: np.load(os.path.join(res, f"{f}_927.npy")).shape
                  for f in ("relError", "sgsTerms", "dnsSgsTerms")}
        check(shapes == dict(relError=(1, 500), sgsTerms=(1, 500, 256),
                             dnsSgsTerms=(1, 5001, 256)), f"{tag}: dumps {shapes}")
        check(launches_t["mlp_forward"] > 0 and launches_t["abcn_macro_step"] == 0,
              f"{tag}: launches {launches_t}")
        test_launches = {k: test_launches[k] + launches_t[k] for k in test_launches}
        print(f"[{tag}] {seconds:.3f} s; test_mean_return {summary['test_mean_return']:.6f}, "
              f"controlled {summary['controlled_cumreward']:.6f} against uncontrolled "
              f"{summary['baseline_cumreward']:.6f}; dumps {shapes}; launches {launches_t}")
    return ts, rep, gen_s, launches, test_launches


def _agree(tag, trajs, dev, tol, what, names=("obs", "actions", "mu", "sigma", "rewards",
                                               "mask", "final_obs"),
           why="float32 cuFFT and the MLP kernel against pocketfft and the module"):
    """The worst error of the card's collection against the CPU's, relative
    to each tensor's max |value|; fails above ``tol``."""
    worst = _rel_err(tag, trajs[dev], trajs["cpu"], names)
    print(f"[{tag}] {what}: max err relative to each tensor's max |value| {json.dumps(worst)} "
          f"(tolerance {tol:g}: {why})")
    check(max(worst.values()) <= tol, f"[{tag}] card and CPU collections disagree: {worst}")


def _rel_err(tag, traj, ref, names):
    """{name: max |traj - ref| / max |ref|} over the tensors ``names`` of two
    collections; fails on a shape mismatch, a non-finite value or actions
    that are all ~0."""
    import torch
    worst = {}
    for name in names:
        a, b = traj[name].cpu(), ref[name].cpu()
        check(a.shape == b.shape and torch.isfinite(a).all(), f"{tag} {name}")
        worst[name] = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
    check(ref["actions"].abs().max() > 1e-3, f"{tag}: the actions are all ~0")
    return worst


def phase_fd_agree(dev):
    """A deterministic burger-fd collection at the run-927 widths (16 envs,
    N_dns 1024, grid 256, 256 actions, a width-32 policy), 20 macro-steps of
    10 FD sub-steps, on the CPU; then the same episodes on the card, which
    take the CPU's actions, and the card's policy on the CPU's observations,
    with the same weights and the same float32 DNS pool, at FD_AGREE_TOL.
    Then the card's own closed-loop collection against the CPU's, at
    FD_CLOSED_TOL: there the policy amplifies the float32 rounding of its
    version-0 observation d2u/dx2 (a second difference of the field)."""
    import dataclasses
    import torch
    from marlpde_tpu_torch.envs import burger_env, registry, rollout
    from marlpde_tpu_torch.rl import vracer
    from marlpde_tpu_torch.train import trainer

    kw = dict(N_dns=1024, grid_size=256, num_actions=256, dt=1e-3, T=0.2, nu=0.02,
              episode_length=20, ic_case="turbulence", scheme="fd")
    pool = burger_env.make_dns_pool(burger_env.BurgerEnvConfig(**kw), 1, device="cpu")
    pools = {"cpu": pool, dev: burger_env.DnsPool(**{
        f.name: getattr(pool, f.name).to(dev) for f in dataclasses.fields(burger_env.DnsPool)})}
    envs = {d: registry.make_env("burger", pool=pools[d], **kw) for d in pools}
    rl_cfg = trainer.default_rl_config(envs["cpu"], width=32, init_noise=0.005, sigma_max=0.05)
    ts = {d: vracer.init_train(rl_cfg, torch.Generator(device=d).manual_seed(9), device=d)
          for d in pools}
    with torch.no_grad():       # a non-zero mean head: the actions are not 0
        for p in ts["cpu"].net.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 0.05)
    ts[dev].net.load_state_dict(ts["cpu"].net.state_dict())
    cpu, _ = rollout.collect_episodes(envs["cpu"], rl_cfg, ts["cpu"], None, 16,
                                      deterministic=True)
    env = envs[dev]
    _agree("fd-agree", {"cpu": cpu, dev: _open_loop(env, rl_cfg, ts[dev], cpu, dev)}, dev,
           FD_AGREE_TOL, "B=16, 20 macro-steps x 10 FD sub-steps, N_dns 1024, grid 256, 256 "
           "actions, the card's env on the CPU's actions and its policy on the CPU's "
           "observations", names=("obs", "mu", "sigma", "rewards", "mask", "final_obs"))
    closed, _ = rollout.collect_episodes(env, rl_cfg, ts[dev], None, 16, deterministic=True)
    _agree("fd-agree", {"cpu": cpu, dev: closed}, dev, FD_CLOSED_TOL,
           "the same, closed loop: the card's collection against the CPU's")


def _open_loop(env, rl_cfg, ts, cpu, dev):
    """The CPU collection ``cpu`` replayed on the card: the card's env steps
    on the CPU's actions and the card's policy acts on the CPU's
    observations; returns the card's obs, mu, sigma, rewards, mask and
    final_obs in the layout of ``collect_episodes``."""
    import torch
    from marlpde_tpu_torch.rl import vracer

    B = cpu["obs"].shape[0]
    state, obs = env.reset_batch(env.consts, None, torch.arange(B, device=dev))
    card = dict(obs=[], mu=[], sigma=[], rewards=[], mask=[])
    for t in range(env.episode_length):
        _, mu, sigma = vracer.policy_apply(rl_cfg, ts, cpu["obs"][:, t].to(dev, obs.dtype))
        card["obs"].append(obs)
        card["mu"].append(mu)
        card["sigma"].append(sigma)
        card["mask"].append((~state.done).to(obs.dtype))
        state, obs, rew, _, _ = env.step(env.consts, state,
                                         cpu["actions"][:, t].to(dev, obs.dtype))
        card["rewards"].append(rew)
    card = {k: torch.stack(v, dim=1) for k, v in card.items()}
    card["final_obs"] = obs
    return card


def phase_variants():
    """One short run on the card of each other Burgers preset and flag set
    (VARIANTS) through the CLI, at VARIANT_DEPTH; coupled-burger and burger
    --dforce (the CLI's default MSE reward) also --test.  Then burger-lockstep,
    which the CLI does not name (in JAX either), through registry.make_env and
    trainer.train at the same depth.  Returns the launches of all of them."""
    import numpy as np
    import torch
    from marlpde_tpu_torch import run
    from marlpde_tpu_torch.envs import registry
    from marlpde_tpu_torch.train import trainer

    total = _no_launches()

    def add(tag, launches):
        check(launches["mlp_forward"] > 0 and launches["abcn_macro_step"] == 0,
              f"{tag}: launches {launches}")
        for k in total:
            total[k] += launches[k]

    for i, variant in enumerate(VARIANTS):
        argv = variant.split() + VARIANT_DEPTH + ["--run", str(i)]
        tag = "variants " + variant
        t0 = time.perf_counter()
        ts, rep, hist, rows, launches = _cli(argv, tag)
        seconds = time.perf_counter() - t0
        if "--dforce" in argv or argv[0] == "coupled-burger":
            check(hist["gen"] == [1, 2] and _finite(hist["mean_return"])
                  and hist["blowups"] == [0, 0], f"{tag}: {hist['gen']}, returns "
                                                 f"{hist['mean_return']}, blowups {hist['blowups']}")
        else:
            # the CLI's default: a generation that lost episodes to blowups is
            # cut short (the -inf truncation penalty, shorter episodes), the
            # others are whole; the run goes on until 1600 live experiences
            for ret, n_blown, ep_len in zip(hist["mean_return"], hist["blowups"],
                                            hist["mean_ep_len"]):
                check((ret == -np.inf and ep_len < 50) if n_blown else
                      (np.isfinite(ret) and ep_len == 50),
                      f"{tag}: return {ret}, blowups {n_blown}, episode length {ep_len}")
            check(len(hist["gen"]) >= 2 and hist["experiences"][-1] >= 1600,
                  f"{tag}: generations {hist['gen']}, experiences {hist['experiences']}")
        _check_state_on_card(tag, ts, rep)
        add(tag, launches)
        line = (f"[{tag}] {seconds:.3f} s for {len(hist['gen'])} generations; returns "
                f"{', '.join(f'{r:.6g}' for r in hist['mean_return'])}; blowups "
                f"{hist['blowups']}, episode lengths {hist['mean_ep_len']}; launches {launches}")
        if variant in ("coupled-burger", "burger --dforce"):
            summary, _, test_s, launches_t = _main_json(argv + ["--test"], tag + " --test")
            check(_finite([summary["test_mean_return"], summary["baseline_cumreward"],
                           summary["controlled_cumreward"]]), f"{tag} --test: {summary}")
            add(tag + " --test", launches_t)
            line += (f"; --test {test_s:.3f} s, controlled {summary['controlled_cumreward']:.6g}"
                     f" against uncontrolled {summary['baseline_cumreward']:.6g}, launches "
                     f"{launches_t}")
        print(line)

    # the CLI's config and learner for these flags (updates in the second
    # generation), with the lockstep DNS in place of the pool
    pool_env, rl_cfg, tc = run.make_workload(run.build_parser().parse_args(
        "burger --dforce --specreward --ic turbulence --nunoise --rstart 800 --maxupd 50".split()
        + VARIANT_DEPTH))
    env = registry.make_env("burger-lockstep", cfg=pool_env.cfg)
    _reset_launches()
    t0 = time.perf_counter()
    ts, rep, hist = trainer.train(env, rl_cfg, tc, verbose=False)
    torch.cuda.synchronize()
    launches = _launches()
    check(hist["gen"] == [1, 2] and _finite(hist["mean_return"]) and hist["blowups"] == [0, 0],
          f"variants burger-lockstep: returns {hist['mean_return']}, blowups {hist['blowups']}")
    _check_state_on_card("variants burger-lockstep", ts, rep)
    add("variants burger-lockstep", launches)
    print(f"[variants burger-lockstep] {time.perf_counter() - t0:.3f} s for 2 generations of 16 "
          f"fresh lockstep DNS (N_dns {env.cfg.N_dns}, nunoise) beside the LES; returns "
          f"{', '.join(f'{r:.6g}' for r in hist['mean_return'])}; launches {launches}; "
          f"updates {hist['updates']}, replay rows {rep.cursor}")
    return total


def _record_episodes(records):
    """Patch ``trainer.collect_episodes`` to append (env name, episode length,
    live steps (B,), each episode's mean return (B,), blown flags (B,)) of
    every collection; returns a function that restores it."""
    from marlpde_tpu_torch.train import trainer
    collect = trainer.collect_episodes

    def recorded(env, *args, **kw):
        traj, final = collect(env, *args, **kw)
        B = traj["mask"].shape[0]
        records.append((env.name, env.episode_length, traj["mask"].sum(1).cpu(),
                        final.cum_reward.reshape(B, -1).mean(-1).cpu(), traj["truncated"].cpu()))
        return traj, final

    trainer.collect_episodes = recorded
    return lambda: setattr(trainer, "collect_episodes", collect)


def _check_early_stop(tag, records):
    """Every episode is whole, or blew up, or (diffusion, advection) stopped
    at a negative cumulative reward, the reference's early stop."""
    import torch
    for name, T, lens, ret, blown in records:
        ok = (lens == T) | blown
        if name != "laplace":
            ok |= (lens < T) & (ret < 0)
        check(bool(ok.all()) and bool((lens >= 1).all()),
              f"{tag}: episodes that break the early-stop rule: lengths {lens.tolist()}, "
              f"returns {ret.tolist()}, blown {blown.tolist()}")
        check(bool(torch.isfinite(ret[~blown]).all()), f"{tag}: returns {ret.tolist()}")


def phase_simple(workdir):
    """The diffusion, advection and Laplace presets through the CLI at their
    run scripts' widths (SIMPLE_RUNS' cuts), then --test of each.  Returns
    the launches of the training runs and of the test stages."""
    import glob

    train_l, test_l = _no_launches(), _no_launches()
    for i, (name, cut) in enumerate(SIMPLE_RUNS.items()):
        argv = [name] + cut.split() + ["--run", str(70 + i)]
        tag = "simple " + name
        records = []
        restore = _record_episodes(records)
        t0 = time.perf_counter()
        try:
            ts, rep, hist, rows, launches = _cli(argv, tag)
        finally:
            restore()
        seconds = time.perf_counter() - t0
        _check_early_stop(tag, records)
        check(_finite(hist["mean_return"]) and len(hist["gen"]) >= 2,
              f"{tag}: generations {hist['gen']}, returns {hist['mean_return']}")
        # korali's ledger over the live steps (rstart, expperu 1, the cap)
        rstart = int(cut.split("--rstart ")[1].split()[0])
        cap = int(cut.split("--maxupd ")[1].split()[0])
        done = 0
        for total, n in zip(hist["experiences"], hist["updates"]):
            want = min(cap, max(0, int(total - rstart) - done)) if total >= rstart else 0
            check(n == want, f"{tag}: {n} updates at {total} live steps, korali's ledger {want}")
            done += n
        check(done > 0 and ts.n_updates == done, f"{tag}: updates {hist['updates']}")
        check(launches["mlp_forward"] > 0 and launches["abcn_macro_step"] == 0,
              f"{tag}: launches {launches}")
        _check_state_on_card(tag, ts, rep)
        lens = [r[2].float().mean().item() for r in records]
        print(f"[{tag}] {seconds:.3f} s for {len(hist['gen'])} generations (obs {ts.net.obs_dim},"
              f" {ts.net.act_dim} actions, width {ts.net.width}); generations "
              f"{', '.join(f'{r['s']:.3f}' for r in rows)} s; returns "
              f"{', '.join(f'{r:.6g}' for r in hist['mean_return'])}; mean episode lengths "
              f"{', '.join(f'{x:.2f}' for x in lens)}; updates {hist['updates']}; "
              f"test returns {hist['test_return']}; launches {launches}")
        for k in train_l:
            train_l[k] += launches[k]
        if name in ("diffusion-simple", "laplace"):
            T = records[0][1]
            phase_cli_breakdown(f"simple-breakdown {name}", argv, ts, rep,
                                f"16 envs x {T} macro-steps", 200, [r["s"] for r in rows])

        summary, line, test_s, launches_t = _main_json(argv + ["--test"], tag + " --test")
        check(list(summary) == ["workload", "test_mean_return", "test_returns"]
              and len(summary["test_returns"]) == 8 and _finite(summary["test_returns"]),
              f"{tag} --test: {summary}")
        check(launches_t["mlp_forward"] > 0 and launches_t["abcn_macro_step"] == 0,
              f"{tag} --test: launches {launches_t}")
        res = os.path.join(workdir, f"_result_{name}_{70 + i}")
        files = set(os.listdir(res))
        want = ({"evolution", "actions", "hessian", "actiondist", "field"} if name == "laplace"
                else {"evolution", "actionfield", "actiondist", "field"})
        check(all(f"{w}.png" in files or f"{w}.npz" in files for w in want),
              f"{tag} --test: files {sorted(files)}")
        extra = ""
        if name != "laplace":
            check("compare.png" in files or "compare_panels.npz" in files,
                  f"{tag} --test: no makePlot comparison in {sorted(files)}")
            curve_files = glob.glob(os.path.join(res, "error_rl_*.json"))
            check(len(curve_files) == 1, f"{tag} --test: error curves {curve_files}")
            with open(curve_files[0]) as f:
                curves = json.load(f)
            T = records[0][1]
            check(curves["survived_steps"] == len(curves["mse"]) >= 1
                  and curves["episode_length"] == T and _finite(curves["mse"]),
                  f"{tag} --test: {curve_files[0]} {curves['survived_steps']}")
            extra = (f"; {os.path.basename(curve_files[0])}: survived "
                     f"{curves['survived_steps']} of {T}, final mse {curves['mse'][-1]:.6g}")
        for k in test_l:
            test_l[k] += launches_t[k]
        print(f"[{tag} --test] {test_s:.3f} s; test_mean_return "
              f"{summary['test_mean_return']:.6g}{extra}; launches {launches_t}")
    return train_l, test_l


def phase_simple_oracle(dev):
    """diffusion-simple's defaults on the card with constant actions, 64
    episodes (results/diffusion_oracle_r5.json): -2 everywhere (the exact
    explicit stencil) and 0 (an untrained sigma-relative policy's mean)."""
    import torch
    from marlpde_tpu_torch.envs import registry

    env = registry.make_env("diffusion-simple", device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    for value, (want_ret, want_len) in ORACLE.items():
        t0 = time.perf_counter()
        state, _ = env.reset(env.consts, g, torch.arange(64, device=dev))
        a = torch.full((64, env.num_agents, env.act_dim), value, device=dev)
        live = torch.zeros(64, device=dev)
        for _ in range(env.episode_length):
            live += (~state.done).float()
            state, _, _, _, _ = env.step(env.consts, state, a)
        torch.cuda.synchronize()
        ret, eplen = state.cum_reward.mean().item(), live.mean().item()
        print(f"[simple-oracle] action {value:g}: mean return {ret:.7g} (JAX {want_ret:.7g}, "
              f"tolerance {ORACLE_TOL:g} absolute), episode length {eplen:g} (JAX {want_len:g}),"
              f" every episode {live.min().item():g}-{live.max().item():g}; "
              f"{time.perf_counter() - t0:.3f} s")
        check(abs(ret - want_ret) <= ORACLE_TOL and eplen == want_len
              and live.min().item() == live.max().item(),
              f"[simple-oracle] action {value}: return {ret}, length {eplen}")


def _simple_collection(name, kw, d, seed, dtype):
    """A deterministic collection of the preset ``name`` on device ``d`` in
    ``dtype``: 16 envs, 20 macro-steps, its run script's policy with the
    float32 weights of init_train's seed 4 plus 0.05 N(0, 1) drawn from
    ``seed`` on the CPU (a non-zero mean head: the actions are not 0), so
    that every device and dtype starts from the same weights.  Returns (env,
    rl_cfg, ts, traj)."""
    import torch
    from marlpde_tpu_torch import run
    from marlpde_tpu_torch.envs import registry, rollout
    from marlpde_tpu_torch.rl import vracer

    _, rl_cfg, _ = run.make_workload(run.build_parser().parse_args([name]), device="cpu")
    env = registry.make_env(name, device=d, dtype=dtype, episode_length=20, **kw)
    net = vracer.init_train(rl_cfg, torch.Generator().manual_seed(4)).net
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    ts = vracer.init_train(rl_cfg, torch.Generator(device=d).manual_seed(4), dtype=dtype,
                           device=d)
    ts.net.load_state_dict(net.state_dict())
    return env, rl_cfg, ts, rollout.collect_episodes(env, rl_cfg, ts, None, 16,
                                                     deterministic=True)[0]


@contextlib.contextmanager
def _module_policy():
    """Act through ``VracerNet`` itself in place of the MLP kernel (a witness
    of the card-against-CPU comparison, not a path of the port)."""
    from marlpde_tpu_torch.kernels import mlp
    kernel = mlp.mlp_forward
    mlp.mlp_forward = lambda obs, net: net(obs)
    try:
        yield
    finally:
        mlp.mlp_forward = kernel


def phase_simple_agree(dev):
    """Deterministic collections of diffusion-simple (no offset noise) and
    laplace at their widths, 16 envs and 20 macro-steps, on the CPU (the
    module), for each seed of SIMPLE_AGREE_SEEDS; then the same episodes on
    the card, which take the CPU's actions, and the card's policy (the MLP
    kernel) on the CPU's observations, with the same weights (open loop):
    its outputs at SIMPLE_AGREE_TOL, the env's at SIMPLE_ENV_TOL.  Then the
    card's own closed-loop collection against the CPU's at SIMPLE_CLOSED_TOL:
    there the explicit stencils step with the policy's actions.  Witnesses
    that the env's errors are float32 rounding, amplified by the stencils:
    the CPU's own float32 collection against its actions replayed in
    float64; the card's closed loop with the module in place of the kernel
    (at SIMPLE_CLOSED_TOL); and both closed loops in float64 (the module on
    the card: the kernel takes float32 only) at SIMPLE_F64_TOL.  Every
    reading is printed before any is checked."""
    import torch

    policy, env_out = ("mu", "sigma"), ("obs", "rewards", "mask", "final_obs")
    every = policy + env_out + ("actions",)
    for name, kw in (("diffusion-simple", dict(noise=0.0)), ("laplace", {})):
        tag = "simple-agree " + name
        rows = {}
        for seed in SIMPLE_AGREE_SEEDS:
            cpu = _simple_collection(name, kw, "cpu", seed, torch.float32)[3]
            env, rl_cfg, ts, closed = _simple_collection(name, kw, dev, seed, torch.float32)
            rows[f"open loop, seed {seed}"] = _rel_err(
                tag, _open_loop(env, rl_cfg, ts, cpu, dev), cpu, policy + env_out)
            if seed == SIMPLE_AGREE_SEEDS[0]:
                first = cpu
                rows[f"closed loop, seed {seed}"] = _rel_err(tag, closed, cpu, every)
        seed = SIMPLE_AGREE_SEEDS[0]
        env64, rl64, ts64, cpu64 = _simple_collection(name, kw, "cpu", seed, torch.float64)
        rows[f"witness, seed {seed}: the CPU's float32 collection's actions replayed in "
             f"float64 on the CPU, against it"] = _rel_err(
            tag, _open_loop(env64, rl64, ts64, first, "cpu"), first, policy + env_out)
        with _module_policy():
            module = _simple_collection(name, kw, dev, seed, torch.float32)[3]
            card64 = _simple_collection(name, kw, dev, seed, torch.float64)[3]
        rows[f"witness, closed loop, seed {seed}: the card acting through the module "
             f"in place of the kernel"] = _rel_err(tag, module, first, every)
        rows[f"witness, closed loop, seed {seed}: float64 on both (the module on the "
             f"card)"] = _rel_err(tag, card64, cpu64, every)
        print(f"[{tag}] B=16, 20 macro-steps, obs {env.obs_dim}, {env.act_dim} actions, "
              f"{env.num_agents} agents; max err relative to each tensor's max |value|, the "
              f"card against the CPU (open loop: the card's env on the CPU's actions and its "
              f"policy on the CPU's observations)")
        for label, errs in rows.items():
            print(f"[{tag}] {label}: {json.dumps(errs)}")
        print(f"[{tag}] tolerances: open loop {SIMPLE_AGREE_TOL:g} on the policy's outputs "
              f"(the MLP kernel against the module) and {SIMPLE_ENV_TOL:g} on the env's "
              f"(float32 stencils, amplified); closed loop and the module witness "
              f"{SIMPLE_CLOSED_TOL:g}; float64 {SIMPLE_F64_TOL:g}")
        for label, errs in rows.items():
            if label.startswith("open loop"):
                check(max(errs[k] for k in policy) <= SIMPLE_AGREE_TOL
                      and max(errs[k] for k in env_out) <= SIMPLE_ENV_TOL,
                      f"[{tag}] {label}: card and CPU disagree: {errs}")
            elif label.startswith("closed loop") or "module" in label:
                check(max(errs.values()) <= SIMPLE_CLOSED_TOL,
                      f"[{tag}] {label}: card and CPU disagree: {errs}")
            elif "float64 on both" in label:
                check(max(errs.values()) <= SIMPLE_F64_TOL,
                      f"[{tag}] {label}: card and CPU disagree: {errs}")


def phase_simple_learns(dev):
    """tests/test_rl.py::TestLearning::test_diffusion_simple_policy_improves
    on the card: VRACER (episode minibatches) on diffusion-simple at N=8 must
    beat its first generations within 50 generations."""
    import numpy as np
    from marlpde_tpu_torch.envs import registry
    from marlpde_tpu_torch.train import trainer

    env = registry.make_env("diffusion-simple", N=8, episode_length=60, noise=0.0, device=dev)
    rl_cfg = trainer.default_rl_config(env, width=32, gamma=0.95, init_noise=3.0, lr=1e-3,
                                       replay_start_experiences=480,
                                       replay_max_experiences=48000, mini_batch_episodes=4)
    tc = trainer.TrainerConfig(num_envs=8, max_experiences=24000, reuse_ratio=64.0,
                               max_updates_per_gen=40, seed=7, log_every=10)
    t0 = time.perf_counter()
    _, _, hist = trainer.train(env, rl_cfg, tc, verbose=False)
    first, last = np.mean(hist["mean_return"][:5]), np.mean(hist["mean_return"][-5:])
    len_first, len_last = np.mean(hist["mean_ep_len"][:5]), np.mean(hist["mean_ep_len"][-5:])
    print(f"[simple-learns] {len(hist['gen'])} generations in {time.perf_counter() - t0:.3f} s:"
          f" mean return of the first 5 {first:.6g}, of the last 5 {last:.6g}; episode length "
          f"{len_first:.2f} -> {len_last:.2f}")
    check(last > first, f"[simple-learns] the policy did not improve: {first} -> {last}")


def phase_bf16():
    """--bf16: the error of a 256x256 float32 matmul against float64 with and
    without the flag's precision, then one short diffusion-simple --bf16 run
    whose library matmuls run at it, and the precision restored after."""
    import torch
    from marlpde_tpu_torch import device as tdevice

    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(256, 256, generator=g, device="cuda")
    b = torch.randn(256, 256, generator=g, device="cuda")
    ref = a.double() @ b.double()
    rel = lambda c: ((c.double() - ref).abs().max() / ref.abs().max()).item()
    plain = rel(a @ b)
    with tdevice.reduced_matmul_precision(torch.device("cuda")):
        lowered = rel(a @ b)
        prec = torch.get_float32_matmul_precision()
    # float32 rounds at 2^-24, TF32 at 2^-11, bf16 at 2^-8 (relative, per product)
    kind = "bf16" if lowered > 2e-3 else "TF32" if lowered > 2e-5 else "float32"
    print(f"[bf16] 256x256 float32 matmul against float64 (max error over the largest |value|):"
          f" {plain:.3e} without the flag, {lowered:.3e} with it (precision {prec!r}, "
          f"allow_tf32 on): cuBLAS gives {kind}")
    check(plain < 1e-5 and lowered >= plain, f"[bf16] errors {plain}, {lowered}")
    seen = []

    def probe(gen, ts, rep, hist):
        seen.append((tdevice.reduced(), torch.backends.cuda.matmul.allow_tf32))

    t0 = time.perf_counter()
    _, _, hist, _, launches = _cli("diffusion-simple --bf16 --NE 600 --rstart 200 --maxupd 100 "
                                   "--run 80".split(), "bf16", also=probe)
    seconds = time.perf_counter() - t0
    check(launches["mlp_forward"] > 0 and launches["abcn_macro_step"] == 0,
          f"[bf16] launches {launches}")
    check(seen and all(s == (True, True) for s in seen), f"[bf16] precision in the run {seen}")
    check(not tdevice.reduced() and not torch.backends.cuda.matmul.allow_tf32,
          "[bf16] the precision was not restored after the run")
    check(_finite(hist["mean_return"]) and sum(hist["updates"]) > 0,
          f"[bf16] returns {hist['mean_return']}, updates {hist['updates']}")
    print(f"[bf16] diffusion-simple --bf16: {len(hist['gen'])} generations, {seconds:.3f} s, "
          f"updates {hist['updates']}, returns "
          f"{', '.join(f'{r:.6g}' for r in hist['mean_return'])}; launches {launches}; "
          f"precision restored after")
    return launches


def _apg_memory(env, rl_cfg, ts, checkpoint):
    """Peak device bytes of one episode_return and its backward pass at the
    env's batch of 16 over APG_MEMORY_STEPS macro-steps, above what was
    allocated before, its seconds and the return."""
    import torch
    from marlpde_tpu_torch.rl import apg

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ts.net.zero_grad(set_to_none=True)
    ret = apg.episode_return(dataclasses.replace(env, episode_length=APG_MEMORY_STEPS), rl_cfg,
                             ts, env.consts, torch.Generator(device=env.device), 0, 16,
                             checkpoint=checkpoint)
    ret.backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ts.net.zero_grad(set_to_none=True)
    return torch.cuda.max_memory_allocated() - base, seconds, ret.item()


def _stream_workspace_bytes():
    """Device bytes that a first matmul on a stream new to cuBLAS leaves
    allocated: the workspace cuBLAS keeps for each stream."""
    import torch

    a = torch.ones((64, 64), device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with torch.cuda.stream(torch.cuda.Stream()):
        b = a @ a
    torch.cuda.synchronize()
    del b
    return torch.cuda.memory_allocated() - base


def _apg_bptt(env, rl_cfg, net_state, eager, depth=APG_MEMORY_STEPS, profile=True):
    """APG_BPTT_ITERATIONS iterations of ``apg.Bptt`` as ``train_apg`` runs
    them, at ``depth`` macro-steps from ``net_state``, graphed or under
    ``graphs.eager()``, then one more, under torch.profiler where graphed and
    ``profile`` (the profiler records every kernel a replay runs, ~1300 a
    macro-step, and an eager iteration's launches too: at 500 macro-steps,
    or eager at 100, reading them back costs minutes).  Returns (the
    tensors to hold bit for bit: each iteration's return and best, the
    parameters, the incumbent, Adam's state, the generator's state; seconds
    of each timed iteration; graph replays of each; ``_profiled`` of the
    profiled one, or None; each timed iteration's peak device bytes above what was
    allocated before the Bptt was made; the tape's bytes)."""
    import torch
    from marlpde_tpu_torch.rl import apg, vracer
    from marlpde_tpu_torch.utils import graphs

    env = dataclasses.replace(env, episode_length=depth)
    ts = vracer.init_train(rl_cfg, torch.Generator(device=env.device), device=env.device)
    ts.net.load_state_dict(net_state)
    g = torch.Generator(device=env.device).manual_seed(5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    seconds, replays, outs, peak = [], [], [], []
    with graphs.eager() if eager else contextlib.nullcontext():
        bptt = apg.Bptt(env, rl_cfg, ts, apg.ApgConfig(batch_size=16), env.consts, g)
        for _ in range(APG_BPTT_ITERATIONS):
            torch.cuda.reset_peak_memory_stats()
            r0, t0 = graphs.replays, time.perf_counter()
            bptt.iteration()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            replays.append(graphs.replays - r0)
            peak.append(torch.cuda.max_memory_allocated() - base)
            outs.append(bptt.out.clone())
        profiled = _profiled(bptt.iteration) if profile and not eager else None
        if profiled is None:
            bptt.iteration()
        outs.append(bptt.out.clone())
    tape = sum(t.numel() * t.element_size() for t in graphs.tensors(bptt.tape))
    state = [v for st in bptt.opt.state.values() for v in st.values()]
    return ([*outs, *bptt.params, *bptt.best, bptt.best_ret, *state, g.get_state()],
            seconds, replays, profiled, peak, tape)


def phase_apg():
    """burger-jax --learner apg through the CLI (RUN_APG): 2 iterations of
    analytic policy gradient through the differentiable RK3 rollout, the
    policy forward through the module (no kernel); then --test of its
    checkpoint, whose acting goes through the MLP kernel.  Then one return
    and its backward pass with and without the per-macro-step checkpointing,
    their peak memory; then train_apg's iterations graphed against
    graphs.eager() (``_apg_bptt``)."""
    import numpy as np
    import torch
    from marlpde_tpu_torch import run
    from marlpde_tpu_torch.rl import apg, vracer
    from marlpde_tpu_torch.utils import graphs

    replays = graphs.replays
    (ts, rep, hist), line, seconds, launches_train = _main_json(RUN_APG, "apg")
    replays = graphs.replays - replays
    print(f"[apg] 2 iterations of 16 episodes x 500 macro-steps x 10 RK3 sub-steps, graphed: "
          f"{seconds:.3f} s ({seconds / 2:.3f} s an iteration, pool, captures and their "
          f"warm-ups included); {replays} graph replays (2 x (2 x 500 + 2) less the 4 "
          f"warm-ups); returns {hist['mean_return']}, best {hist['best_return'][-1]}; "
          f"launches {launches_train}")
    check(replays == 2 * (2 * 500 + 2) - 4, f"[apg] {replays} graph replays in training")
    check(line == {"workload": "burger-jax", "learner": "apg",
                   "final_mean_return": hist["mean_return"][-1], "iterations": 2},
          f"[apg] JSON line {line}")
    check(rep is None and _finite(hist["mean_return"]), f"[apg] returns {hist['mean_return']}")
    check(launches_train == _no_launches(),
          f"[apg] training launched a kernel: {launches_train}")
    # the same generator draws the same initial weights as train_apg's
    args = run.build_parser().parse_args(RUN_APG)
    env, rl_cfg, _ = run.make_workload(args)
    ts0 = vracer.init_train(rl_cfg, torch.Generator(device=env.device).manual_seed(args.seed),
                            device=env.device)
    # the return improved, so the incumbent is a later iterate: the
    # checkpoint's weights moved from the initial ones
    best_it = int(np.argmax(hist["mean_return"]))
    moved = [not torch.equal(a, b) for a, b in zip(ts.net.parameters(), ts0.net.parameters())]
    print(f"[apg] incumbent from iteration {best_it}; parameters that differ from the initial "
          f"ones: {sum(moved)} of {len(moved)}")
    check(best_it > 0 and hist["best_return"][-1] == hist["mean_return"][best_it] and any(moved),
          f"[apg] incumbent {best_it}, moved {moved}, returns {hist['mean_return']}")
    absolute = dataclasses.replace(rl_cfg, mu_param="absolute")
    state = vracer.init_train(absolute, torch.Generator().manual_seed(APG_BLOWN_SEED)).net
    blown = vracer.init_train(absolute, torch.Generator(device=env.device), device=env.device)
    blown.net.load_state_dict(state.state_dict())
    t0 = time.perf_counter()
    with torch.no_grad():
        ret = apg.episode_return(env, absolute, blown, env.consts,
                                 torch.Generator(device=env.device), 0, 16).item()
    print(f"[apg] an untrained absolute-mean policy (the CPU's seed-{APG_BLOWN_SEED} weights): "
          f"return {ret} ({time.perf_counter() - t0:.3f} s; its episodes blow up, as most "
          f"untrained absolute-mean policies' do on the CPU and in JAX)")
    check(ret == -np.inf, f"[apg] seed {APG_BLOWN_SEED}'s untrained return {ret}")

    summary, tline, t_seconds, launches_test = _main_json(
        RUN_APG[:4] + ["--test", "--run", "81"], "apg-test")
    print(f"[apg] --test of the checkpoint: {t_seconds:.3f} s, mean return "
          f"{summary['test_mean_return']:.6g}; launches {launches_test}")
    check(_finite(summary["test_returns"]) and len(summary["test_returns"]) == 8,
          f"[apg] --test summary {summary}")
    check(launches_test["mlp_forward"] > 0 and launches_test["abcn_macro_step"] == 0,
          f"[apg] --test launches {launches_test}")

    mem = {ck: _apg_memory(env, rl_cfg, ts0, ck) for ck in (True, False)}
    print(f"[apg] one return and its backward pass at 16 episodes x {APG_MEMORY_STEPS} "
          f"macro-steps, peak device memory above the baseline: " + "; ".join(
              f"{'with' if ck else 'without'} checkpointing {b / 2**20:.1f} MiB in {t:.3f} s "
              f"(return {r:.6g})" for ck, (b, t, r) in mem.items()))
    check(mem[True][2] == mem[False][2], f"[apg] the two passes' returns differ: {mem}")

    print(f"[apg] a matmul on a stream new to cuBLAS leaves "
          f"{_stream_workspace_bytes() / 2**20:.3f} MiB allocated (its workspace; the graphs' "
          f"warm-ups and captures share one side stream)")
    state = ts0.net.state_dict()
    runs = {eager: _apg_bptt(env, rl_cfg, state, eager) for eager in (False, True)}
    (got, sec_g, rep_g, prof_g, peak_g, tape), (want, sec_e, rep_e, _, peak_e, _) = (
        runs[False], runs[True])
    same = [_same(a, b)[0] for a, b in zip(got, want)]
    T = APG_MEMORY_STEPS
    # graphed at the CLI's 500 macro-steps, timed only (an eager iteration there takes ~20 s)
    _, sec_500, rep_500, _, peak_500, tape_500 = _apg_bptt(env, rl_cfg, state, False, 500,
                                                          profile=False)
    wall, busy, calls = prof_g[:3]
    print(f"[apg] a graphed iteration at 16 episodes x {T} macro-steps under torch.profiler: "
          f"{wall:.3f} s, device busy {busy / wall:.1%}; host runtime calls {json.dumps(calls)}; "
          f"the profiler's own {prof_g[4]:.1f} s")
    print(f"[apg] graphed at 16 episodes x 500 macro-steps: seconds an iteration "
          f"{', '.join(f'{t:.4f}' for t in sec_500)} (the first captures), graph replays "
          f"{rep_500}; peak device memory above the baseline "
          f"{', '.join(f'{b / 2**20:.1f}' for b in peak_500)} MiB (the tape "
          f"{tape_500 / 2**20:.1f} MiB)")
    check(rep_500 == [998, 1002], f"[apg] graph replays at 500 macro-steps {rep_500}")
    print(f"[apg] {APG_BPTT_ITERATIONS} APG iterations (Bptt, as train_apg runs them) at 16 "
          f"episodes x {T} macro-steps, graphed against graphs.eager(): "
          f"{sum(same)} of {len(same)} tensors bitwise equal (returns, parameters, incumbent, "
          f"Adam's state, generator); seconds an iteration graphed "
          f"{', '.join(f'{t:.4f}' for t in sec_g)} (the first captures), eager "
          f"{', '.join(f'{t:.4f}' for t in sec_e)} ({sec_e[-1] / sec_g[-1]:.1f}x); graph "
          f"replays an iteration {rep_g} (2 T + 2 = {2 * T + 2}; the first iteration's 4 steps "
          f"are the captures' warm-ups); peak device memory above the baseline of each "
          f"iteration graphed {', '.join(f'{b / 2**20:.1f}' for b in peak_g)} MiB (the tape "
          f"{tape / 2**20:.1f} MiB), eager {', '.join(f'{b / 2**20:.1f}' for b in peak_e)} MiB; "
          f"returns {[float(o[0]) for o in got[:3]]}")
    check(all(same) and len(same) == len(want), f"[apg] graphed against eager: {same}")
    check(rep_g == [2 * T + 2 - 4] + [2 * T + 2] * (APG_BPTT_ITERATIONS - 1) and set(rep_e) == {0},
          f"[apg] graph replays an iteration {rep_g}, eager {rep_e}")
    check(prof_g[2].get("cudaGraphLaunch", 0) == 2 * T + 2,
          f"[apg] host calls of a graphed iteration {prof_g[2]}")
    return {k: launches_train[k] + launches_test[k] for k in launches_train}


def _apg_agree_grads(d, dtype, net_state, bptt=False):
    """episode_return at APG_AGREE on device ``d`` in ``dtype`` from the
    weights ``net_state``: (return, {name: gradient as float64 on the CPU});
    with ``bptt``, the same return and gradient as ``train_apg`` computes
    them (apg.Bptt's forward tape and reverse VJPs; graphs on the card)."""
    import torch
    from marlpde_tpu_torch.envs import registry
    from marlpde_tpu_torch.rl import apg, vracer
    from marlpde_tpu_torch.train import trainer

    env = registry.make_env("burger-jax", dtype=dtype, device=d, **APG_AGREE)
    rl_cfg = trainer.default_rl_config(env, width=256, init_noise=0.01)
    ts = vracer.init_train(rl_cfg, torch.Generator(device=d).manual_seed(0), dtype=dtype,
                           device=d)
    ts.net.load_state_dict(net_state)
    if bptt:
        run = apg.Bptt(env, rl_cfg, ts, apg.ApgConfig(batch_size=4), env.consts,
                       torch.Generator(device=d))
        run.steps["begin"]()
        for name in ("forward", "vjp"):
            for _ in range(run.T):
                run.steps[name]()
        # Bptt's gradients are of minus the return, which train_apg descends
        return torch.mean(run.acc).item(), {n: -g.double().cpu() for (n, _), g in
                                            zip(ts.net.named_parameters(), run.grads)}
    ret = apg.episode_return(env, rl_cfg, ts, env.consts, torch.Generator(device=d), 0, 4)
    ret.backward()
    return ret.item(), {n: p.grad.detach().double().cpu() for n, p in ts.net.named_parameters()
                        if p.grad is not None}


def _jacobians(d, dtype):
    """burger_grad's step_with_grad (10 sub-steps) and episode_jacobian (5
    macro-steps of 10) at burger-jax's N = NA = 32, from numpy-made inputs."""
    import numpy as np
    import torch
    from marlpde_tpu_torch.envs import burger_env
    from marlpde_tpu_torch.solvers import burger_grad

    cfg = burger_env.BurgerEnvConfig(**APG_AGREE, scheme="rk3")
    rng = np.random.default_rng(0)
    x = np.linspace(0, 2 * np.pi, 32, endpoint=False)
    t = lambda a: torch.tensor(a, dtype=dtype, device=d)
    u = t(np.sin(x) + 0.1 * rng.standard_normal(32))
    _, _, g = burger_grad.step_with_grad(cfg.les_solver, burger_env.action_basis(cfg), u,
                                         torch.fft.fft(u), t(np.zeros((32, 32))),
                                         t(0.1 * rng.standard_normal(32)), 10)
    jac = burger_grad.episode_jacobian(cfg.les_solver, burger_env.action_basis(cfg), u,
                                       t(0.1 * rng.standard_normal((5, 32))), 10)
    return {"step_with_grad": g.double().cpu(), "episode_jacobian": jac.double().cpu()}


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def phase_apg_agree(dev):
    """The APG return and every parameter's gradient, and burger_grad's two
    Jacobians, on the card against the CPU: float32 within AGREE_FACTOR times
    the CPU's own float32 distance from float64, float64 at AGREE_F64_TOL."""
    import torch
    from marlpde_tpu_torch.envs import registry
    from marlpde_tpu_torch.rl import vracer
    from marlpde_tpu_torch.train import trainer

    env = registry.make_env("burger-jax", device="cpu", **APG_AGREE)
    rl_cfg = trainer.default_rl_config(env, width=256, init_noise=0.01)
    state = vracer.init_train(rl_cfg, torch.Generator().manual_seed(3)).net.state_dict()
    t0 = time.perf_counter()
    runs = {(d, dt): _apg_agree_grads(d, dt, state)
            for d in ("cpu", dev) for dt in (torch.float32, torch.float64)}
    runs.update({("bptt", dt): _apg_agree_grads(dev, dt, state, bptt=True)
                 for dt in (torch.float32, torch.float64)})
    jacs = {(d, dt): _jacobians(d, dt) for d in ("cpu", dev)
            for dt in (torch.float32, torch.float64)}
    seconds = time.perf_counter() - t0

    def dist(a, b):
        (ra, ga), (rb, gb) = runs[a], runs[b]
        return {"return": abs(ra - rb) / abs(rb), **{n: _rel(ga[n], gb[n]) for n in gb}}

    f32, f64 = torch.float32, torch.float64
    for what, card, witness, f64_err in (
            ("episode_return and its gradients", dist((dev, f32), ("cpu", f32)),
             dist(("cpu", f32), ("cpu", f64)), dist((dev, f64), ("cpu", f64))),
            ("burger_grad Jacobians",
             {k: _rel(jacs[(dev, f32)][k], jacs[("cpu", f32)][k]) for k in jacs[("cpu", f32)]},
             {k: _rel(jacs[("cpu", f32)][k], jacs[("cpu", f64)][k]) for k in jacs[("cpu", f32)]},
             {k: _rel(jacs[(dev, f64)][k], jacs[("cpu", f64)][k]) for k in jacs[("cpu", f32)]})):
        print(f"[apg-agree] {what}, max error over the largest |value|: card against CPU in "
              f"float32 {json.dumps({k: float(f'{v:.3e}') for k, v in card.items()})}; the CPU's "
              f"float32 against float64 (the witness) "
              f"{json.dumps({k: float(f'{v:.3e}') for k, v in witness.items()})}; card against "
              f"CPU in float64 {json.dumps({k: float(f'{v:.3e}') for k, v in f64_err.items()})}")
        check(all(card[k] <= AGREE_FACTOR * max(witness[k], 1e-7) for k in card),
              f"[apg-agree] {what}: the card is farther from the CPU than {AGREE_FACTOR:g}x "
              f"the CPU's float32 rounding")
        check(max(f64_err.values()) <= AGREE_F64_TOL, f"[apg-agree] {what} in float64: {f64_err}")
    graphed = dist(("bptt", f32), (dev, f32))
    graphed64 = dist(("bptt", f64), (dev, f64))
    witness = dist(("cpu", f32), ("cpu", f64))
    print(f"[apg-agree] train_apg's return and gradient on the card (apg.Bptt graphed: the "
          f"forward tape and the reverse VJPs) against the checkpointed episode_return's, max "
          f"error over the largest |value|: float32 "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in graphed.items()})}; float64 "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in graphed64.items()})}")
    check(all(graphed[k] <= AGREE_FACTOR * max(witness[k], 1e-7) for k in graphed),
          f"[apg-agree] Bptt is farther from the checkpointed gradient than {AGREE_FACTOR:g}x "
          f"the CPU's float32 rounding")
    check(max(graphed64.values()) <= AGREE_F64_TOL, f"[apg-agree] Bptt in float64: {graphed64}")
    print(f"[apg-agree] B=4, 20 macro-steps, width 256; returns: card {runs[(dev, f32)][0]:.7g},"
          f" CPU {runs[('cpu', f32)][0]:.7g} (float32); {seconds:.3f} s")


def phase_cmaes(dev):
    """cmaes-burger through the CLI (RUN_CMAES), then the card's objective
    at CMAES_CS against the CPU's, and graphed against graphs.eager()."""
    import numpy as np
    import torch
    from marlpde_tpu_torch.rl import cmaes
    from marlpde_tpu_torch.utils import graphs

    out, line, seconds, launches = _main_json(RUN_CMAES, "cmaes")
    print(f"[cmaes] 3 generations of 8 episodes x 500 macro-steps x 10 ABCN sub-steps, "
          f"graphed: {seconds:.3f} s ({seconds / 3:.3f} s a generation, the pool and the "
          f"capture included); {line}; "
          f"launches {launches}")
    check(out == line and list(line) == ["workload", "best_cs", "best_objective", "generations"]
          and line["generations"] == 3 and 0.0 <= line["best_cs"] <= 1.0
          and np.isfinite(line["best_objective"]), f"[cmaes] JSON line {line}")
    xs = np.asarray(CMAES_CS)[:, None]
    costs, secs = {}, {}
    for d, dt in ((dev, torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        f = cmaes.make_burger_cs_objective(device=d, dtype=dt)
        if d is dev:
            f_card = f
        t0 = time.perf_counter()
        costs[(d, dt)] = f(xs)
        secs[(d, dt)] = time.perf_counter() - t0
    # the card's objective again: its graph's replays alone, then under eager
    for tag in ("graphed", "eager"):
        replays = graphs.replays
        with graphs.eager() if tag == "eager" else contextlib.nullcontext():
            t0 = time.perf_counter()
            costs[tag] = f_card(xs)
            secs[tag] = time.perf_counter() - t0
        replays = graphs.replays - replays
        check(replays == (500 if tag == "graphed" else 0), f"[cmaes] {tag}: {replays} replays")
    same = [np.array_equal(costs[t], costs[(dev, torch.float32)]) for t in ("graphed", "eager")]
    print(f"[cmaes] objective at cs {CMAES_CS} (500 macro-steps of 10 ABCN sub-steps), graphed "
          f"against graphs.eager(): bitwise equal {same}; seconds graphed "
          f"{secs[(dev, torch.float32)]:.4f} (with the capture), {secs['graphed']:.4f} (500 "
          f"replays), eager {secs['eager']:.4f} ({secs['eager'] / secs['graphed']:.1f}x)")
    check(all(same), f"[cmaes] graphed against eager: {costs}")
    card = costs[(dev, torch.float32)]
    cpu = costs[("cpu", torch.float32)]
    err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    witness = float(np.abs(cpu - costs[("cpu", torch.float64)]).max() / np.abs(cpu).max())
    print(f"[cmaes] objective at cs {CMAES_CS}: card {card.tolist()} ({secs[(dev, torch.float32)]:.3f}"
          f" s), CPU {cpu.tolist()} ({secs[('cpu', torch.float32)]:.3f} s); max error over the "
          f"largest |cost| {err:.3e}, the CPU's float32 against float64 {witness:.3e} "
          f"(limit {AGREE_FACTOR:g}x)")
    check(np.isfinite(card).all() and err <= AGREE_FACTOR * max(witness, 1e-7),
          f"[cmaes] the card's objective {card} against the CPU's {cpu}")
    return launches


def _ddp_card(cfg, u0, draws, net, perms, dev, eager):
    """The ddp pipeline on the card, graphed or under ``graphs.eager()``:
    the DNS (4000 steps), the filter, 80 epochs of closure training at batch
    64, the a-posteriori rollout from frame 190, a transfer step (Dense_0-5
    frozen, 5 epochs at batch 25).  Returns (U, F, u_bar, PI, f_bar, the
    model, the rollout, the transferred model, seconds per stage)."""
    import torch
    from marlpde_tpu_torch.ddp import pipeline
    from marlpde_tpu_torch.utils import graphs

    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    tr, te, start = slice(0, 150), slice(150, 200), 190
    with graphs.eager() if eager else contextlib.nullcontext():
        U, F = timed("dns", lambda: pipeline.generate_dns(cfg, 4000, u0=u0, draws=draws,
                                                          dtype=torch.float64, device=dev))
        u_bar, pi, f_bar = timed("filter", lambda: pipeline.calc_bar(
            U[::cfg.s], F[::cfg.s], cfg.n_les, cfg.L))
        model = timed("train", lambda: pipeline.train_closure(
            u_bar[tr], pi[tr], epochs=80, batch_size=64, net=net, perms=perms))
        uu = timed("rollout", lambda: pipeline.aposteriori_rollout(
            model, cfg, u_bar[start], u_bar[start - 1], f_bar[start:],
            len(f_bar) - start - 1))
        m2 = timed("transfer", lambda: pipeline.train_closure(
            u_bar[te], pi[te], torch.Generator(device=dev).manual_seed(2), epochs=5,
            batch_size=25, net=model.net, trainable_mask=pipeline.transfer_mask(model.net)))
    return U, F, u_bar, pi, f_bar, model, uu, m2, times


def _ddp_repeats(cfg, model, u_bar, pi, f_bar, eager):
    """Median seconds of DDP_REPEATS calls each of ``_ddp_card``'s rollout
    and transfer step on its trained ``model``, graphed or under
    ``graphs.eager()``."""
    import statistics

    import torch
    from marlpde_tpu_torch.ddp import pipeline
    from marlpde_tpu_torch.utils import graphs

    start, te = 190, slice(150, 200)
    stages = {"rollout": lambda: pipeline.aposteriori_rollout(
                  model, cfg, u_bar[start], u_bar[start - 1], f_bar[start:],
                  len(f_bar) - start - 1),
              "transfer": lambda: pipeline.train_closure(
                  u_bar[te], pi[te], torch.Generator(device=u_bar.device).manual_seed(2),
                  epochs=5, batch_size=25, net=model.net,
                  trainable_mask=pipeline.transfer_mask(model.net))}
    seconds = {}
    with graphs.eager() if eager else contextlib.nullcontext():
        for stage, fn in stages.items():
            times = []
            for _ in range(DDP_REPEATS):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            seconds[stage] = statistics.median(times)
    return seconds


def phase_ddp(dev):
    """tests/test_ddp.py::TestPipelineScale on the card: the N=1024
    stochastic DNS (4000 steps), the filter to n_les=128, the closure trained
    for 80 epochs at batch 64, its a-priori score against static
    Smagorinsky's, the a-posteriori rollout from frame 190; then a transfer
    step (Dense_0-5 frozen), graphed and under graphs.eager(), bit for bit;
    and the card against this machine's CPU from the
    same draws, net and permutations: the DNS, u_bar and PI over all 4000
    steps and the closure's weights after 1 and 80 epochs (float64), and the
    DNS over DDP_AGREE_STEPS in float32.  Returns the path's kernel launches."""
    import copy

    import numpy as np
    import torch
    from marlpde_tpu_torch.ddp import pipeline
    from marlpde_tpu_torch.solvers import closures

    f64 = torch.float64
    cfg = pipeline.DdpConfig()
    # the draws generate_dns and train_closure make from these seeds on the CPU
    g = torch.Generator().manual_seed(DDP_SEEDS[0])
    phase = torch.randn((), generator=g, dtype=f64) * 2.0 * np.pi
    draws = torch.randn((4000 // cfg.s, 2, 3), generator=g, dtype=f64)
    x = torch.as_tensor(np.linspace(0.0, cfg.L, cfg.N, endpoint=False), dtype=f64)
    u0 = torch.sin(2.0 * np.pi * 2.0 * x / cfg.L + phase)
    g = torch.Generator().manual_seed(DDP_SEEDS[1])
    net_cpu = pipeline.ClosureNet(cfg.n_les, n_out=cfg.n_les, dtype=f64, generator=g)
    net = copy.deepcopy(net_cpu).to(dev)
    perms = [torch.randperm(150, generator=g) for _ in range(80)]

    # the first run builds the cuFFT plans and the libraries' handles
    first = _ddp_card(cfg, u0, draws, net, perms, dev, False)[-1]
    runs = {"eager": _ddp_card(cfg, u0, draws, net, perms, dev, True)}
    _reset_launches()
    runs["graphed"] = _ddp_card(cfg, u0, draws, net, perms, dev, False)
    launches = _launches()
    (U, F, u_bar, pi, f_bar, model, uu, m2, times) = runs["graphed"]
    tr, te = slice(0, 150), slice(150, 200)
    start = 190
    n_roll = len(f_bar) - start - 1
    check(U.shape == (4001, 1024) and U.is_cuda and bool(torch.isfinite(U).all()),
          f"[ddp] DNS {tuple(U.shape)}")
    ev = pipeline.apriori_eval(model, u_bar[te], pi[te])
    smag = closures.ssm_forcing(u_bar[te], cfg.L / cfg.n_les, cfg.n_les).cpu().numpy()
    corr_smag = float(np.corrcoef(smag.ravel(), pi[te].cpu().numpy().ravel())[0, 1])

    def held(run):
        U, F, u_bar, pi, _, model, uu, m2, _ = run
        return [U, F, u_bar, pi, *model.net.parameters(), uu, *m2.net.parameters()]

    bits = [_same(x, y)[0] for x, y in zip(held(runs["graphed"]), held(runs["eager"]))]
    eager = runs["eager"][-1]
    print(f"[ddp] graphed (one graph per DNS forcing block, per training epoch, per LES step) "
          f"against graphs.eager(): {sum(bits)} of {len(bits)} tensors bitwise equal (U, F, "
          f"u_bar, PI, the trained and the transferred weights, the rollout); seconds graphed "
          f"{json.dumps({k: round(v, 4) for k, v in times.items()})} (each with its capture; "
          f"the first run {json.dumps({k: round(v, 4) for k, v in first.items()})}), eager "
          f"{json.dumps({k: round(v, 4) for k, v in eager.items()})}")
    check(all(bits), f"[ddp] graphed against eager: {bits}")
    med = {tag: _ddp_repeats(cfg, model, u_bar, pi, f_bar, tag == "eager")
           for tag in ("graphed", "eager")}
    print(f"[ddp] medians of {DDP_REPEATS} calls (graphed: each call with its own capture): "
          + "; ".join(f"{stage} graphed {med['graphed'][stage]:.5f} s, eager "
                      f"{med['eager'][stage]:.5f} s" for stage in med["eager"]))
    same = [torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
            for a, b in zip(model.net.dense, m2.net.dense)]
    print(f"[ddp] N=1024 DNS 4000 steps, n_les=128, 80 epochs at batch 64 (float64): a-priori "
          f"correlation {ev['correlation']:.6f} (mse {ev['mse']:.6g}; limit 0.45 and above "
          f"static Smagorinsky's |{corr_smag:.6f}|); rollout of {n_roll} LES steps from frame "
          f"{start}: finite {bool(torch.isfinite(uu).all())}, max |u| {uu.abs().max().item():.6g}"
          f" (limit 50); transfer step (Dense_0-5 frozen) leaves layers unchanged: {same}; "
          f"seconds {json.dumps({k: round(v, 3) for k, v in times.items()})}; launches {launches}")
    check(ev["correlation"] > 0.45 and ev["correlation"] > abs(corr_smag),
          f"[ddp] a-priori correlation {ev}, static Smagorinsky {corr_smag}")
    check(uu.shape == (n_roll + 1, 128) and bool(torch.isfinite(uu).all())
          and uu.abs().max().item() < 50.0, "[ddp] a-posteriori rollout")
    check(same == [True] * 6 + [False] * 2, f"[ddp] transfer step: layers unchanged {same}")

    t0 = time.perf_counter()
    U_c, F_c = pipeline.generate_dns(cfg, 4000, u0=u0, draws=draws, dtype=f64, device="cpu")
    ub_c, pi_c, _ = pipeline.calc_bar(U_c[::cfg.s], F_c[::cfg.s], cfg.n_les, cfg.L)
    one = [pipeline.train_closure(u[tr], p[tr], epochs=1, batch_size=64, net=n, perms=perms[:1])
           for u, p, n in ((u_bar, pi, net), (ub_c, pi_c, net_cpu))]
    model_c = pipeline.train_closure(ub_c[tr], pi_c[tr], epochs=80, batch_size=64, net=net_cpu,
                                     perms=perms)
    ev_c = pipeline.apriori_eval(model_c, ub_c[te], pi_c[te])
    times["cpu"] = time.perf_counter() - t0

    def flat(m):
        return torch.cat([p.detach().flatten().cpu() for p in m.net.parameters()])

    errs = {"U": _rel(U.cpu(), U_c), "u_bar": _rel(u_bar.cpu(), ub_c), "pi": _rel(pi.cpu(), pi_c),
            "weights_epoch1": _rel(flat(one[0]), flat(one[1])),
            "weights_epoch80": _rel(flat(model), flat(model_c)),
            "correlation": abs(ev["correlation"] - ev_c["correlation"])}
    runs = [pipeline.generate_dns(cfg, DDP_AGREE_STEPS, u0=u0, draws=draws[:10],
                                  dtype=torch.float32, device=d)[0].double().cpu()
            for d in (dev, "cpu")]
    errs["U_float32"] = _rel(*runs)
    print(f"[ddp] card against this machine's CPU from the same draws, net and permutations "
          f"(max error over the largest value; float64 but U_float32, over "
          f"{DDP_AGREE_STEPS} steps): {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}"
          f"; the CPU's correlation {ev_c['correlation']:.6f}, {times['cpu']:.3f} s")
    check(max(v for k, v in errs.items() if k != "U_float32") <= AGREE_F64_TOL
          and errs["U_float32"] <= 1e-4, f"[ddp] the card against the CPU: {errs}")
    return launches


@contextlib.contextmanager
def _all_reduces():
    """Record every torch.distributed.all_reduce: yields a list that gets
    (CUDA start event, end event, host seconds, backend) per call made
    outside a capture (a capture refuses timing events: the calls it records
    run in the replays, which ``pmesh.all_reduces`` counts)."""
    import torch
    import torch.distributed as dist
    real = dist.all_reduce
    calls = []

    def timed(tensor, *args, group=None, **kw):
        if torch.cuda.is_current_stream_capturing():
            return real(tensor, *args, group=group, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = real(tensor, *args, group=group, **kw)
        end.record()
        calls.append((start, end, time.perf_counter() - t0, dist.get_backend(group)))
        return out

    dist.all_reduce = timed
    try:
        yield calls
    finally:
        dist.all_reduce = real


def phase_mesh(cli_ms_per_update):
    """The run-918 flags with --mesh at a world of 1 through the CLI: the NCCL
    group, 3 generations (updates from the second, replays of 50 updates
    captured with their all_reduces) and --resume for a fourth; the same 3
    generations under ``graphs.eager()``, held bit for bit against the
    graphed ones.  Prints seconds per generation, ms per update graphed and
    eager beside [cli-breakdown]'s, the all_reduces per update (counted per
    replay) and the captures of each run.  Returns the graphed runs'
    launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from marlpde_tpu_torch.parallel import mesh as pmesh
    from marlpde_tpu_torch.train import trainer
    from marlpde_tpu_torch.utils import graphs

    def run(argv, tag, eager=False):
        # CUDA events around each generation's updates (replays, or eager
        # calls), the captures made, and after each generation the
        # all_reduces and updates so far
        marks, timed, captures = [], [], collections.Counter()
        real_updates, real_capture = trainer.run_updates, graphs.capture

        def run_updates(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = real_updates(*args, **kw)
            end.record()
            timed.append((start, end))
            return out

        def capture(name, fn, *args, **kw):
            captures[name + (" (test)" if getattr(fn, "deterministic", False) else "")] += 1
            return real_capture(name, fn, *args, **kw)

        def also(gen, ts, rep, hist):
            marks.append((pmesh.all_reduces, int(ts.n_updates), len(timed)))

        trainer.run_updates, graphs.capture = run_updates, capture
        pmesh.all_reduces = 0
        try:
            with _all_reduces() as calls, graphs.eager() if eager else contextlib.nullcontext():
                ts, rep, hist, rows, launches = _cli(argv, tag, also)
                torch.cuda.synchronize()
        finally:
            trainer.run_updates, graphs.capture = real_updates, real_capture
        check(not dist.is_initialized(), f"{tag}: the CLI left its process group behind")
        check({c[3] for c in calls} == {"nccl"}, f"{tag}: all_reduce backends "
                                                  f"{ {c[3] for c in calls} }")
        _check_state_on_card(tag, ts, rep)
        prev = 0
        for r, (n_calls, n_upd, _) in zip(rows, marks):
            print(f"[{tag}] gen {r['gen']}: {r['s']:.3f} s, mean_return "
                  f"{hist['mean_return'][r['gen'] - 1]:.6f}, ep_len "
                  f"{hist['mean_ep_len'][r['gen'] - 1]:.1f}, n_updates {n_upd}, "
                  f"all_reduces +{n_calls - prev}, launches abcn +{r['d_abcn']} "
                  f"mlp +{r['d_mlp']}", flush=True)
            check(r["d_abcn"] >= 500 and r["d_mlp"] >= 500 and np.isfinite(
                hist["mean_return"][r["gen"] - 1]), f"{tag} gen {r['gen']}")
            prev = n_calls
        upd_ms = [s.elapsed_time(e) / MESH_UPDATES for s, e in timed]
        print(f"[{tag}] captures: {dict(captures)}; ms per update in each generation with "
              f"updates (CUDA events around the {'eager calls' if eager else 'replays'}): "
              f"{', '.join(f'{m:.4f}' for m in upd_ms) or 'none'}")
        device_ms = [c[0].elapsed_time(c[1]) for c in calls]
        host_ms = [1000 * c[2] for c in calls]
        return ts, rep, hist, rows, marks, launches, captures, upd_ms, device_ms, host_ms

    flags = RUN_MESH + ["--NE", "15000"]
    ts, rep, hist, rows, marks, launches, captures, upd_ms, _, _ = run(flags, "mesh")
    check(hist["gen"] == [1, 2, 3] and [m[1] for m in marks] == [0, MESH_UPDATES,
                                                                 2 * MESH_UPDATES],
          f"mesh: generations {hist['gen']}, updates {[m[1] for m in marks]}")
    check(hist["experiences"] == [g * 10 * 500 for g in (1, 2, 3)], f"mesh {hist['experiences']}")
    check(captures == {"burger-marl macro-step": 1,
                       f"{trainer.UPDATE_CHUNK} experience-mode updates": 1},
          f"mesh: captures in the run {dict(captures)} (one macro-step and one chunk of "
          f"updates a run)")
    per_gen = [marks[0][0]] + [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    per_update = (per_gen[1] - per_gen[0]) / MESH_UPDATES
    check(per_update == int(per_update) >= 1 and per_gen[2] == per_gen[1],
          f"mesh: all_reduces per generation {per_gen}")

    # the same generations eagerly (a comparison: their launches do not count)
    e_ts, e_rep, e_hist, e_rows, _, _, e_captures, e_upd_ms, e_dev, e_host = run(
        flags + ["--run", "90"], "mesh-eager", eager=True)
    check(not e_captures, f"mesh-eager: captures {dict(e_captures)}")
    left = graphs.tensors((list(ts.net.parameters()), list(ts.opt.state.values()), ts.beta,
                           ts.n_updates, ts.obs_stats, ts.rew_stats, rep))
    right = graphs.tensors((list(e_ts.net.parameters()), list(e_ts.opt.state.values()),
                            e_ts.beta, e_ts.n_updates, e_ts.obs_stats, e_ts.rew_stats, e_rep))
    same = sum(_same(a, b)[0] for a, b in zip(left, right))
    print(f"[mesh] graphed against eager over 3 generations: {same} of {len(left)} tensors "
          f"bitwise equal (parameters, Adam's state, beta, the counter, the normalizers, "
          f"the replay shard); returns {hist['mean_return']} against {e_hist['mean_return']}")
    check(same == len(left) == len(right) and hist["mean_return"] == e_hist["mean_return"],
          "mesh: the graphed generations differ from the eager ones")
    gen_s = ", ".join(f"{r['s']:.3f}" for r in rows)
    e_gen_s = ", ".join(f"{r['s']:.3f}" for r in e_rows)
    print(f"[mesh] seconds per generation graphed {gen_s}, eager {e_gen_s} (generation 1 "
          f"collects and inserts, 2 and 3 also run {MESH_UPDATES} updates); ms per update "
          f"graphed {upd_ms[-1]:.4f} (generation 3: replays only; generation 2 with the "
          f"capture {upd_ms[0]:.4f}), eager {e_upd_ms[0]:.4f} and {e_upd_ms[1]:.4f}; "
          f"[cli-breakdown] {cli_ms_per_update:.4f} in this call "
          f"({100 * (upd_ms[-1] / cli_ms_per_update - 1):+.1f}%)")
    print(f"[mesh] all_reduces: {per_gen[0]} a generation outside the updates (normalizers, "
          f"replay gate, stats) and {int(per_update)} per update (gradients, off-policy "
          f"counts), inside each replay; eager device time {np.median(e_dev):.4f} ms "
          f"median per call, host {np.median(e_host):.4f} ms (NCCL, world 1)")

    hist, rows2, marks2, launches2 = run(RUN_MESH + ["--NE", "20000", "--resume"],
                                         "mesh-resume")[2:6]
    check(hist["gen"] == [1, 2, 3, 4] and marks2[-1][1] == 2 * MESH_UPDATES,
          f"mesh resume: generations {hist['gen']}, n_updates {marks2[-1][1]} (the replay "
          f"restarts empty: 5000 live steps, under --rstart)")
    return {k: launches[k] + launches2[k] for k in launches}


def phase_mesh2(workdir):
    """Two ranks on the card under gloo, spawned by parallel.dryrun: the dry
    run (both modes, the train state equal bit for bit across the ranks, the
    DCP checkpoint restored on each), then the run-918 flags at 5 envs a rank
    for 2 generations.  Returns the path's launches, summed over the ranks."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)

    def dryrun(tag, args):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "marlpde_tpu_torch.parallel.dryrun",
                              "--world", "2", "--device", "cuda", "--timeout", "400", *args],
                             cwd=workdir, env=env, capture_output=True, text=True, timeout=450)
        seconds = time.perf_counter() - t0
        for ln in (out.stderr + out.stdout).splitlines():
            if ln.strip() and "hostname of the client" not in ln:
                print(f"[{tag}] | {ln}")
        check(out.returncode == 0, f"{tag}: exit {out.returncode}")
        verdict = json.loads(out.stdout.strip().splitlines()[-1])
        check(verdict["ok"] and verdict["processes"] == 2, f"{tag}: {verdict}")
        check("backend gloo (ranks share a card)" in out.stderr, f"{tag}: backend")
        print(f"[{tag}] {seconds:.1f} s, launches by rank {verdict['launches']}")
        return out, verdict

    out, verdict = dryrun("mesh-2", ["--out", os.path.join(workdir, "dryrun")])
    check(out.stderr.count("experience-mode OK") == 2 and out.stderr.count("episode-mode OK") == 2,
          "mesh-2: a mode or a rank did not pass")
    check(all(r["mlp_forward"] > 0 for r in verdict["launches"]), "mesh-2: MLP not launched")
    # each rank's launches and experience-mode updates (the dry run's, then the
    # CLI's: run 918's flags, experience mode)
    ranks = [dict(r, experience_updates=u)
             for r, u in zip(verdict["launches"], verdict["experience_updates"])]
    out, verdict = dryrun("mesh-2-cli", ["--cli", *RUN_MESH2])
    lines = verdict["json_lines"]
    check(lines[1] == [] and len(lines[0]) == 1 and lines[0][0]["mesh_devices"] == 2
          and lines[0][0]["generations"] == 2 and _finite([lines[0][0]["final_mean_return"]]),
          f"mesh-2-cli: JSON lines {lines}")
    check(len(set(verdict["digests"])) == 1 and verdict["n_updates"] == [100, 100],
          f"mesh-2-cli: digests {verdict['digests']}, updates {verdict['n_updates']}")
    check(all(r["abcn_macro_step"] >= 1000 and r["mlp_forward"] >= 1000
              for r in verdict["launches"]), f"mesh-2-cli: launches {verdict['launches']}")
    ranks += [dict(r, experience_updates=u)
              for r, u in zip(verdict["launches"], verdict["n_updates"])]
    print(f"[mesh-2-cli] both ranks' train states equal bit for bit after "
          f"{verdict['n_updates'][0]} updates: {verdict['digests'][0][:16]}; seconds since "
          f"the first generation began, after each, by rank {verdict['wall_time']}")
    check(all(r["vracer_loss"] == HEAD_LAUNCHES * r["experience_updates"] > 0 for r in ranks),
          f"mesh-2: loss head launches by rank and run {ranks}")
    return {k: sum(r[k] for r in ranks) for k in ranks[0]}


def ptxas_by_instantiation(log, kernel, want):
    """{template argument: (registers, spill store bytes, spill load bytes)}
    of each instantiation of the kernel template ``kernel`` in ptxas's -v
    report; ``want`` lists the template arguments that must be there."""
    out = {}
    for block in log.split("Compiling entry function")[1:]:
        n = re.search(kernel + r"ILi(\d+)E", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        if n and regs and spill:
            out[int(n.group(1))] = (int(regs.group(1)), int(spill.group(1)),
                                    int(spill.group(2)))
    check(sorted(out) == list(want), f"ptxas report of {kernel}: {sorted(out)}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    from marlpde_tpu_torch.device import resolve_device
    from marlpde_tpu_torch.envs import registry
    from marlpde_tpu_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = resolve_device("cuda")

    t0 = time.perf_counter()
    build.build_all(("abcn", "mlp", "vracer_loss"))
    for name in ("abcn", "mlp", "vracer_loss"):
        build.load(name)
    print(f"[build] abcn.cu, mlp.cu and vracer_loss.cu built (in parallel) and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    head_log = build.build_logs["vracer_loss"]
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", head_log)]
    spills = [int(a) + int(b) for a, b in
              re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", head_log)]
    print(f"[build] vracer_loss: {len(regs)} kernel instantiations, at most {max(regs)} "
          f"registers, {sum(spills)} bytes of spill stores and loads in all")
    mlp_ptxas = ptxas_by_instantiation(build.build_logs["mlp"], "mlp_forward_kernel",
                                       range(32, 257, 32))
    print("[build] mlp narrow route: " + ", ".join(
        f"W={w}: {r} registers, {st}/{ld} bytes spill stores/loads"
        for w, (r, st, ld) in sorted(mlp_ptxas.items())))
    spilling = [w for w, (_, st, ld) in sorted(mlp_ptxas.items()) if st or ld]
    print(f"[build] mlp narrow-route widths that spill: {spilling}")
    wide_ptxas = ptxas_by_instantiation(build.build_logs["mlp"], "mlp_wide_kernel",
                                        range(32, 257, 32))
    print("[build] mlp wide route: " + ", ".join(
        f"W={w}: {r} registers, {st}/{ld} bytes spill stores/loads"
        for w, (r, st, ld) in sorted(wide_ptxas.items())))
    print(f"[build] mlp wide-route widths that spill: "
          f"{[w for w, (_, st, ld) in sorted(wide_ptxas.items()) if st or ld]}")
    warnings = [ln.strip() for ln in build.build_logs["mlp"].splitlines()
                if "warning" in ln or "Performance Loss" in ln]
    if warnings:
        print(f"[build] mlp ptxas warnings: {' | '.join(warnings)}")
    abcn_ptxas = ptxas_by_instantiation(build.build_logs["abcn"], "abcn_macro_step_kernel",
                                        range(11))
    print("[build] abcn: " + ", ".join(
        f"N={1 << n}: {r} registers, {st}/{ld} bytes spill stores/loads"
        for n, (r, st, ld) in sorted(abcn_ptxas.items())))
    regs32, st32, ld32 = abcn_ptxas[5]
    print(f"[build] abcn N=32 (the main path's instantiation): {regs32} registers, "
          f"{st32} bytes spill stores, {ld32} bytes spill loads")
    check(st32 == ld32 == 0, "the ABCN kernel spills at N=32")
    sass = subprocess.run([os.path.join(os.path.dirname(build._nvcc()), "cuobjdump"), "-sass",
                           str(build.library_path("mlp"))], capture_output=True, text=True,
                          check=True).stdout
    n_hgmma = sum("HGMMA" in ln for ln in sass.splitlines())
    print(f"[build] mlp: {n_hgmma} HGMMA (wgmma) instructions in the SASS")
    check(n_hgmma > 0, "the MLP kernel has no tensor-core instructions")

    t0 = time.perf_counter()
    env = registry.make_env("burger", dtype=torch.float32, device=dev, **FLAGSHIP)
    print(f"[setup] flagship env (host DNS pool {tuple(env.consts.uu.shape)}) in "
          f"{time.perf_counter() - t0:.2f} s; obs_dim {env.obs_dim}")

    marks = [("setup", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    _count_experience_updates()
    kernels, head_rows = phase_kernels(env, dev)
    mark("kernels")
    ts, rep, rl_cfg, launches_main = phase_main_path(env)
    mark("main")
    phase_breakdown(env, ts, rep, rl_cfg)
    mark("breakdown")
    phase_small_agreement(dev)
    mark("small")
    phase_f2(dev)
    mark("f2")
    launches_lockstep = phase_lockstep(dev, smi)
    mark("lockstep")
    del ts, rep
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as workdir:
        os.chdir(workdir)
        try:
            phase_graphs(env, workdir)
            mark("graphs")
            ts, rep, launches_cli = phase_cli(workdir)
            mark("cli")
            cli_ms = phase_cli_breakdown("cli-breakdown", RUN_918, ts, rep,
                                         "10 envs x 500 macro-steps", 2500)
            mark("cli-breakdown")
            launches_cli_test = phase_cli_test(workdir)
            mark("cli-test")
            launches_w256 = phase_cli_w256()
            mark("cli-w256")
            launches_mesh = phase_mesh(cli_ms)
            mark("mesh")
            launches_mesh2 = phase_mesh2(workdir)
            mark("mesh-2")
            del ts, rep
            ts, rep, gen_s, launches_ks, launches_ks_test = phase_ks(workdir)
            mark("ks")
            phase_cli_breakdown("ks-breakdown", RUN_926, ts, rep,
                                "16 envs x 500 macro-steps x 4 ETDRK4 sub-steps", 1000, gen_s)
            mark("ks-breakdown")
            del ts, rep
            ts, rep, gen_s, launches_fd, launches_fd_test = phase_fd(workdir)
            mark("fd")
            phase_cli_breakdown("fd-breakdown", RUN_927, ts, rep,
                                "10 envs x 500 macro-steps x 10 FD sub-steps", 2500, gen_s)
            mark("fd-breakdown")
            del ts, rep
            launches_variants = phase_variants()
            mark("variants")
            launches_simple, launches_simple_test = phase_simple(workdir)
            mark("simple")
            launches_bf16 = phase_bf16()
            mark("bf16")
        finally:
            os.chdir(here)
    phase_fast_off(dev)
    mark("fast-off")
    phase_ks_agree(dev)
    mark("ks-agree")
    phase_fd_agree(dev)
    mark("fd-agree")
    phase_simple_oracle(dev)
    mark("simple-oracle")
    phase_simple_agree(dev)
    mark("simple-agree")
    phase_simple_learns(dev)
    mark("simple-learns")
    with tempfile.TemporaryDirectory() as workdir:
        os.chdir(workdir)
        try:
            launches_apg = phase_apg()
            mark("apg")
        finally:
            os.chdir(here)
    phase_apg_agree(dev)
    mark("apg-agree")
    launches_cmaes = phase_cmaes(dev)
    mark("cmaes")
    launches_ddp = phase_ddp(dev)
    mark("ddp")
    by_path = dict(main=launches_main, cli=launches_cli, cli_w256=launches_w256,
                   cli_test=launches_cli_test, ks=launches_ks, ks_test=launches_ks_test,
                   fd=launches_fd, fd_test=launches_fd_test, variants=launches_variants,
                   simple=launches_simple, simple_test=launches_simple_test,
                   bf16=launches_bf16, apg=launches_apg, cmaes=launches_cmaes,
                   ddp=launches_ddp, mesh=launches_mesh, mesh2=launches_mesh2,
                   lockstep=launches_lockstep)
    # the flagship Burgers paths run both kernels; KS has its own solver, the
    # other Burgers configs run the general per-env env (torch.fft), and the
    # diffusion, advection and Laplace envs have no Burgers solver: the MLP
    # kernel only.  APG differentiates the module and acts through the kernel
    # in its --test stage; CMA-ES and the ddp pipeline have no VRACER policy
    # and run their own ABCN loops on torch.fft: neither kernel
    burgers = ("main", "cli", "cli_w256", "cli_test", "mesh", "mesh2", "lockstep")
    no_policy = ("cmaes", "ddp")
    for k in kernels:
        k["launches"] = launches_cli[k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
        want = (lambda p, n: (n > 0) != (p in no_policy)) if k["name"] == "mlp_forward" else (
            lambda p, n: (n > 0) == (p in burgers))
        check(all(want(p, n) for p, n in k["launches_by_path"].items()),
              f"{k['name']} launches by path {k['launches_by_path']}")

    # the loss head: HEAD_LAUNCHES a path's experience-mode updates, which run
    # on every VRACER training path but the main path (episode mode) and
    # [cli-w256] (one generation, before the replay starts); none in APG, in
    # the --test stages, in CMA-ES or in the ddp pipeline
    print("[launches] loss head by path (launches, experience-mode updates): " + json.dumps(
        {p: [c["vracer_loss"], c["experience_updates"]] for p, c in by_path.items()}))
    experience = ("cli", "ks", "fd", "variants", "simple", "bf16", "mesh", "mesh2", "lockstep")
    check(all(c["vracer_loss"] == HEAD_LAUNCHES * c["experience_updates"]
              and (c["experience_updates"] > 0) == (p in experience) for p, c in by_path.items()),
          "loss head launches by path: "
          + json.dumps({p: [c["vracer_loss"], c["experience_updates"]] for p, c in by_path.items()}))
    for row in head_rows:
        row["launches"] = launches_cli["vracer_loss"]
        row["launches_by_path"] = {p: c["vracer_loss"] for p, c in by_path.items()}

    print("[timing] seconds per phase: " + json.dumps(
        {name: round(t - prev, 3) for (_, prev), (name, t) in zip(marks, marks[1:])}))
    print(json.dumps({"kernels": kernels + head_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
