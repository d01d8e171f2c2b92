"""The port's entry points run on the card unless the caller asks for the CPU:
``device.resolve_device(None)``, ``registry.make_env`` (every preset) and
``run.main`` / ``run.make_workload`` without a device (training, KS, the
--test stage, cmaes-burger, --learner apg and --mesh), ``ddp.pipeline.generate_dns``,
``cmaes.make_burger_cs_objective`` and the multi-process dry run
(``parallel.dryrun``, both modes) raise where torch.cuda is not
available, and ``device="cpu"`` runs.  torch.cuda.is_available is patched to
False, so these hold on a machine with a card too.  No JAX is imported."""

import pytest
import torch

from marlpde_tpu_torch import device as tdevice
from marlpde_tpu_torch import run as trun
from marlpde_tpu_torch.envs import registry

torch.set_num_threads(1)

TINY = ("burger-marl --nagents 4 --specreward --dforce --ic turbulence --NDNS 64 --dt 0.01 "
        "--T 0.1 --episodelength 5 --numenvs 2 --mbsize 8 --rstart 10 --NE 20 "
        "--run 997").split()
ENV_KW = dict(N_dns=64, grid_size=32, num_actions=32, num_agents=4, dt=0.01, T=0.1,
              nu=0.05, episode_length=5, ic_case="turbulence", spectral_reward=True)
KS_KW = dict(N_dns=64, grid_size=16, num_actions=16, t_transient=5.0, t_end=15.0,
             episode_length=5)
KS_TINY = "ks --NDNS 64 --N 16 --NA 16 --episodelength 5 --width 8 --run 996".split()
NO_CARD = "torch.cuda is not available"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_none_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError, match=NO_CARD):
        tdevice.resolve_device()


@pytest.mark.parametrize("asked", ["cuda", "cuda:0", torch.device("cuda")])
def test_resolve_device_cuda_raises_without_a_card(no_card, asked):
    with pytest.raises(RuntimeError, match=NO_CARD):
        tdevice.resolve_device(asked)


@pytest.mark.parametrize("asked", ["cpu", torch.device("cpu")])
def test_resolve_device_cpu_runs(no_card, asked):
    assert tdevice.resolve_device(asked) == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("name", ["burger", "burger-marl", "burger-fd", "burger-jax",
                                  "coupled-burger", "burger-lockstep"])
def test_make_env_without_device_raises_without_a_card(no_card, name):
    # the coupled preset sets its own reward
    kw = {k: v for k, v in ENV_KW.items()
          if not (name == "coupled-burger" and k == "spectral_reward")}
    with pytest.raises(RuntimeError, match=NO_CARD):
        registry.make_env(name, **kw)


def test_make_env_on_the_cpu_when_asked(no_card):
    env = registry.make_env("burger-marl", device="cpu", **ENV_KW)
    assert env.consts.uu.device == torch.device("cpu") and env.whole_batch


def test_make_workload_without_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match=NO_CARD):
        trun.make_workload(trun.build_parser().parse_args(TINY))
    env, _, _ = trun.make_workload(trun.build_parser().parse_args(TINY), device="cpu")
    assert env.consts.uu.device == torch.device("cpu")


def test_main_without_device_raises_and_writes_nothing(no_card, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match=NO_CARD):
        trun.main(TINY)
    assert list(tmp_path.iterdir()) == []


def test_main_mesh_without_device_raises_and_starts_nothing(no_card, tmp_path, monkeypatch):
    """--mesh resolves the rank's device before it starts a process group."""
    import torch.distributed as dist
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match=NO_CARD):
        trun.main(TINY + ["--mesh"])
    assert list(tmp_path.iterdir()) == [] and not dist.is_initialized()


@pytest.mark.parametrize("mode", [[], ["--cli", *TINY, "--mesh"]], ids=["dryrun", "cli"])
def test_dryrun_without_device_raises_and_starts_no_rank(no_card, monkeypatch, mode):
    """The dry run resolves the device in the parent, before any rank; with
    --device cuda too.  Ranks would start through subprocess.Popen."""
    from marlpde_tpu_torch.parallel import dryrun
    started = []
    monkeypatch.setattr(dryrun.subprocess, "Popen", lambda *a, **kw: started.append(a))
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match=NO_CARD):
            dryrun.main(["--world", "2", *device, *mode])
    assert started == []


def test_main_on_the_cpu_when_asked(no_card, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ts, rep, hist = trun.main(TINY, device="cpu")
    assert hist["gen"] == [1, 2] and capsys.readouterr().out.count("[trainer] gen ") == 2
    assert all(p.device == torch.device("cpu") for p in ts.net.parameters())


def test_make_env_ks_raises_without_a_card_and_runs_on_the_cpu(no_card):
    with pytest.raises(RuntimeError, match=NO_CARD):
        registry.make_env("ks", **KS_KW)
    env = registry.make_env("ks", device="cpu", **KS_KW)
    assert env.consts.uu.device == torch.device("cpu") and env.name == "ks"


@pytest.mark.parametrize("extra", [[], ["--test"], ["--test", "--best"]],
                         ids=["train", "test", "test-best"])
def test_main_ks_and_test_without_device_raise_and_write_nothing(no_card, tmp_path,
                                                                 monkeypatch, extra):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match=NO_CARD):
        trun.main(KS_TINY + extra)
    with pytest.raises(RuntimeError, match=NO_CARD):
        trun.main(TINY + extra)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("name", ["diffusion-simple", "diffusion-error", "diffusion-stencil3",
                                  "advection-simple", "laplace"])
def test_simple_presets_raise_without_a_card_and_run_on_the_cpu(no_card, name):
    """The envs without a pool: their consts hold the device, resolved like
    every other preset's."""
    with pytest.raises(RuntimeError, match=NO_CARD):
        registry.make_env(name)
    env = registry.make_env(name, device="cpu")
    assert env.device == torch.device("cpu") and env.dtype == torch.float32


@pytest.mark.parametrize("extra", [[], ["--bf16"], ["--test", "--bf16"]],
                         ids=["train", "bf16", "test-bf16"])
def test_main_of_a_simple_preset_without_device_raises_and_keeps_the_precision(
        no_card, tmp_path, monkeypatch, extra):
    """Without a card --bf16 raises before it lowers any precision, and
    writes nothing."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match=NO_CARD):
        trun.main(["laplace", "--nagents", "4", "--episodelength", "5"] + extra)
    assert list(tmp_path.iterdir()) == []
    assert not tdevice.reduced() and not torch.backends.cuda.matmul.allow_tf32


CMAES_TINY = "cmaes-burger --NDNS 32 --N 8 --dt 0.01 --T 0.05 --episodelength 5 --numgen 1"
APG_TINY = ("burger-jax --NDNS 32 --N 8 --NA 8 --dt 0.01 --T 0.05 --episodelength 5 "
            "--numenvs 2 --NE 10 --width 8 --learner apg --run 995")


@pytest.mark.parametrize("argv", [CMAES_TINY, CMAES_TINY + " --test", APG_TINY],
                         ids=["cmaes", "cmaes-test", "apg"])
def test_main_of_the_other_learners_raises_without_a_card_and_runs_on_the_cpu(
        no_card, argv, tmp_path, monkeypatch, capsys):
    """cmaes-burger (also under --test) and --learner apg build their pool on
    the card unless asked for the CPU."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match=NO_CARD):
        trun.main(argv.split())
    assert list(tmp_path.iterdir()) == []
    trun.main(argv.split(), device="cpu")
    assert capsys.readouterr().out.count("{") == 1


def test_the_other_entry_points_raise_without_a_card(no_card):
    from marlpde_tpu_torch.ddp import pipeline
    from marlpde_tpu_torch.rl import cmaes

    cfg = pipeline.DdpConfig(N=64, n_les=16)
    with pytest.raises(RuntimeError, match=NO_CARD):
        pipeline.generate_dns(cfg, 20, torch.Generator())
    U, F = pipeline.generate_dns(cfg, 20, torch.Generator(), device="cpu")
    assert U.device.type == "cpu" and U.shape == (21, 64)
    kw = dict(N_dns=32, grid_size=8, dt=0.01, T=0.05, episode_length=5)
    with pytest.raises(RuntimeError, match=NO_CARD):
        cmaes.make_burger_cs_objective(**kw)
    assert cmaes.make_burger_cs_objective(device="cpu", **kw)([[0.1]]).shape == (1,)
