"""The port's data x fsdp mesh (`parallel/mesh.py`) against the JAX
package's `parallel/mesh.py`, and the sharded training steps against the
one-process ones, on the CPU.

`mesh_shape` and `_fsdp_spec` as JAX's on its 8 virtual devices; then
gloo process groups started by torchrun from the test: 2 ranks (data 1 x
fsdp 2) and 4 (data 2 x fsdp 2) take one tiny ControlNet step and one tiny
distillation step, sharded, against the same steps in one process on the
same draws (and at 4 ranks, a batch of 3 that the data axis does not
divide), each step twice:
  fp32, what the trainers run: the loss to rtol 1e-4 and the masters,
    working copy and EMA element by element to the JAX package's sharding
    limits (`tests/test_train_sharding.py:117-127`: rtol 2e-3, atol
    3 x lr), and every tree (masters, working copy, EMA, Adam's two
    moments) to FP32_STEP_REL = 0.3 of the step's move;
  float64 (the models and the batch, so the forward and the backward):
    the same element-wise limits, Adam's first moment element by element,
    every tree to STEP_REL = 1e-5 of its move and the loss to rtol 2e-6.
    What stays fp32 there: the masters and Adam's moments, the gradients
    from where they are averaged over the data ranks or used by the
    optimizer, the ControlNet's loss (an fp32 mean, as JAX's) and every
    metric averaged over the data ranks; so the loss's limit is an fp32
    one, a few of its roundings.
Why two limits of the move: at 32 px the fp32 gradients are
ill-conditioned (4 x 4 latents, GroupNorm over a handful of values
deeper down), so the sharded and one-process data means round near-zero
gradients apart by the host's rounding, and a first Adam step, about lr
whatever the gradient's size, turns that into a move of 2 lr the other
way: fp32 reads up to 0.08 of the move at 4 ranks on one host and under
1e-3 on another.  A skipped, doubled or EMA-less update reads about 1
in both dtypes; float64 sees the data axis to 1e-5.  Then the dry run
at 4 ranks; `train_controlnet --fsdp 2` against the one-process CLI, with
the latent cache filled over the ranks and without.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from diffcodec_tpu.config import MeshConfig as JMeshConfig
from diffcodec_tpu.parallel import mesh as jmesh

from diffcodec_tpu_torch.config import MeshConfig
from diffcodec_tpu_torch.parallel import dryrun, mesh
from diffcodec_tpu_torch.train import checkpoint

from tests.test_torch_port_train_cli import _write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4


@pytest.mark.parametrize("kw", [dict(), dict(fsdp_size=2),
                                dict(fsdp_size=8), dict(fsdp_size=3),
                                dict(data_size=2, fsdp_size=4),
                                dict(data_size=3, fsdp_size=2)])
def test_mesh_shape_and_errors_are_jaxs(kw):
    devices = jax.devices()[:8]
    assert len(devices) == 8
    try:
        want = jmesh.make_mesh(JMeshConfig(**kw), devices=devices)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.mesh_shape(MeshConfig(**kw), 8)
        assert str(got.value) == str(e)
        return
    data, fsdp = mesh.mesh_shape(MeshConfig(**kw), 8)
    assert {"data": data, "fsdp": fsdp} == dict(want.shape)


SHAPES = [(), (7,), (8,), (320, 4, 3, 3), (3, 3, 4, 320), (64, 64),
          (1, 1280), (77, 768), (6, 10, 6), (5, 7), (2,), (4, 4, 4)]


@pytest.mark.parametrize("fsdp", [1, 2, 3, 4, 8])
def test_fsdp_spec_is_jaxs(fsdp):
    for shape in SHAPES:
        want = tuple(jmesh._fsdp_spec(shape, "fsdp", fsdp))
        assert mesh._fsdp_spec(shape, "fsdp", fsdp) == want, shape


def test_param_shardings_split_the_port_controlnet():
    """The rule on the port's OIHW shapes: every tensor has a spec, most
    of the tiny ControlNet's elements are split over 2 ranks."""
    _, controlnet, _ = dryrun.tiny_models("cpu")
    params = dict(controlnet.named_parameters())

    class Mesh2:
        axis_names, fsdp_size = ("data", "fsdp"), 2

    specs = mesh.param_shardings(Mesh2, params)
    assert set(specs) == set(params)
    split = sum(p.numel() for n, p in params.items() if specs[n])
    assert split > 0.95 * sum(p.numel() for p in params.values())
    for n, p in params.items():
        assert specs[n] == mesh._fsdp_spec(tuple(p.shape), "fsdp", 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(n: int, args, timeout=600):
    """`args` (a module and its arguments) under torchrun with n CPU ranks
    on 127.0.0.1; returns the completed process (checked)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         f"--nproc_per_node={n}", "--master_addr=127.0.0.1",
         f"--master_port={_free_port()}", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return proc


_STEPS = r"""
import sys

import torch

from diffcodec_tpu_torch.cli.train_distill import step_generator
from diffcodec_tpu_torch.config import MeshConfig
from diffcodec_tpu_torch.parallel import dryrun, mesh as pm
from diffcodec_tpu_torch.train.checkpoint import _map_tensors

torch.set_num_threads(1)
out, fsdp = sys.argv[1], int(sys.argv[2])
sizes = [int(b) for b in sys.argv[3].split(",")]
m = pm.make_mesh(MeshConfig(fsdp_size=fsdp), "cpu")
LR = 1e-4
result = {}
for B in sizes:
    for kind in ("controlnet", "distill"):
        make = (dryrun.controlnet_trainer if kind == "controlnet"
                else dryrun.distiller)
        for dtype in (torch.float32, torch.float64):
            runs = {}
            for sharded in (False, True):
                trainer, state = make(dryrun.tiny_models("cpu"), dtype=dtype,
                                      lr=LR)
                batch = {k: v.to(dtype)
                         for k, v in dryrun.tiny_batch(B, 32, "cpu").items()}
                if sharded:
                    state = trainer.shard_state(m, state)
                else:
                    runs["init"] = _map_tensors(state.state_dict(),
                                                lambda t: t.clone())
                # the global batch on every rank: the trainer keeps its rows
                state, metrics = trainer.train_step(
                    state, batch, step_generator(0, 0, "cpu"))
                sd = state.state_dict()
                net = (trainer.controlnet if kind == "controlnet"
                       else trainer.student)
                runs[sharded] = dict(
                    loss=metrics["loss_mse" if kind == "controlnet"
                                 else "loss"].item(),
                    params=sd["params"], opt_state=sd["opt_state"],
                    ema=sd.get("ema_params"),
                    working={n: p.detach().clone()
                             for n, p in net.named_parameters()})
            result[B, kind, str(dtype)] = runs
if pm.is_writer():
    result["mesh"] = m.shape
    torch.save(result, out)
torch.distributed.barrier()
"""

# a step's distance from the one-process step, relative to the step's
# move from the initial state (each tree's norm over all its tensors).
# float64: the steps agree to within 4e-6 of the move at 2 and 4 ranks
STEP_REL = 1e-5
# fp32: a first Adam step moves an element by about lr whatever the size
# of its gradient, so where the sharded and the one-process means round a
# near-zero gradient to opposite signs the element moves 2 lr the other
# way; how many do depends on the host's rounding (0.004 and 0.077 of the
# move at 4 ranks on one host, under 1e-3 on another).  The limit sits
# above that and below a skipped, doubled or EMA-less update's 1.0
FP32_STEP_REL = 0.3
# the training CLI's fp32 checkpoints (two steps at 32 px, 2 ranks of
# fsdp and no data axis, so no data mean to round)
CLI_STEP_REL = 1e-3


def _rel_to_move(got, want, init):
    apart = torch.cat([(got[n] - want[n]).flatten() for n in sorted(want)])
    move = torch.cat([(want[n] - init[n]).flatten() for n in sorted(want)])
    assert move.norm() > 0
    return (apart.norm() / move.norm()).item()


@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    """{(data, fsdp): the worker's result} for 2 and 4 gloo ranks: a
    global batch of 8 on both, and of 3 (which the data axis of 2 does not
    divide, so every rank steps on all of it) on 4; each step in fp32 and
    in float64."""
    d = tmp_path_factory.mktemp("mesh")
    script = d / "steps.py"
    script.write_text(_STEPS)
    out = {}
    for n, sizes in ((2, "8"), (4, "8,3")):
        path = str(d / f"steps{n}.pt")
        _torchrun(n, [str(script), path, "2", sizes])
        res = torch.load(path, weights_only=False)
        out[tuple(res["mesh"].values())] = res
    return out


def _check_sharded_step(runs, kind, dtype):
    """The sharded step against the one-process one, both in `dtype`: the
    loss, the trees (masters, working copy, EMA) to the JAX package's
    sharding limits and every tree, both moments too, to FP32_STEP_REL
    (fp32) or STEP_REL (float64) of its move; in float64 also Adam's
    first moment element by element.  In fp32 the first moments are the
    gradients' own rounding (up to 9e-5 apart at 4 ranks on one host, on
    moments of 1e-4), so only the float64 step holds them element by
    element."""
    one, sharded, init = runs[False], runs[True], runs["init"]
    wide = dtype == "torch.float64"
    np.testing.assert_allclose(sharded["loss"], one["loss"],
                               rtol=2e-6 if wide else 1e-4)
    names = ["params", "working"] + (["ema"] if kind == "distill" else [])
    # tree -> (sharded, one-process, initial)
    trees = {t: (sharded[t], one[t], init["ema_params" if t == "ema"
                                          else "params"]) for t in names}
    trees.update({k: (sharded["opt_state"][k], one["opt_state"][k],
                      init["opt_state"][k]) for k in ("mu", "nu")})
    for tree, (got, want, start) in trees.items():
        assert set(got) == set(want)
        for n, w in want.items():
            assert got[n].shape == w.shape, n
            if tree in names:
                np.testing.assert_allclose(got[n].numpy(), w.numpy(),
                                           rtol=2e-3, atol=3 * LR,
                                           err_msg=f"{tree}: {n}")
        rel = _rel_to_move(got, want, start)
        assert rel < (STEP_REL if wide else FP32_STEP_REL), (tree, rel)
    moved = 0
    for n, want in one["opt_state"]["mu"].items():
        if wide:
            np.testing.assert_allclose(
                sharded["opt_state"]["mu"][n].numpy(), want.numpy(),
                rtol=2e-3, atol=1e-6, err_msg=n)
        moved += int(want.abs().sum() > 0)
    assert moved > 0.5 * len(one["opt_state"]["mu"])
    assert sharded["opt_state"]["count"] == one["opt_state"]["count"] == 1
    # the working copy holds the gathered masters
    for n, p in sharded["working"].items():
        assert torch.equal(p, sharded["params"][n].to(p.dtype)), n


DTYPES = ("torch.float32", "torch.float64")


@pytest.mark.parametrize("layout", [(1, 2), (2, 2)])
@pytest.mark.parametrize("kind", ["controlnet", "distill"])
def test_sharded_step_matches_one_process(sharded_steps, layout, kind):
    for dtype in DTYPES:
        _check_sharded_step(sharded_steps[layout][8, kind, dtype], kind,
                            dtype)


@pytest.mark.parametrize("kind", ["controlnet", "distill"])
def test_sharded_step_with_a_replicated_batch(sharded_steps, kind):
    """A global batch of 3 on 2 data ranks: each steps on all 3 rows with
    the one-process draws, so the step is still the one-process step."""
    for dtype in DTYPES:
        _check_sharded_step(sharded_steps[2, 2][3, kind, dtype], kind,
                            dtype)


def test_dryrun_completes_at_4_ranks(tmp_path):
    path = str(tmp_path / "dryrun.json")
    _torchrun(4, ["-m", "diffcodec_tpu_torch.parallel.dryrun", "--device",
                  "cpu", "--out", path])
    import json
    with open(path) as f:
        res = json.load(f)["dryrun"]
    assert res["mesh"] == {"data": 2, "fsdp": 2}
    assert np.isfinite(res["train"]["loss_mse"])
    assert np.isfinite(res["distill"]["loss"])
    assert res["decode"]["frames"] == 4
    assert (res["tiled"]["tiles"], res["tiled"]["pad"]) == (15, 1)
    assert res["sparse"] == dict(chunks=3, chunk=2,
                                 launches=res["sparse"]["launches"])


def _train_controlnet_runs(tmp_path, *extra):
    """`train_controlnet` at tiny size for 2 steps (checkpoint-2), once in
    one process and once under torchrun with `--fsdp 2` (2 gloo ranks,
    data 1 x fsdp 2), with `extra` options (`{run}` in them naming each
    run's directory); returns (the one-process run's arguments, its
    directory, the sharded run's directory)."""
    index, captions = _write_dataset(str(tmp_path / "data"), 4)
    common = ["--index_file", index, "--caption_file", captions,
              "--resolution", "32", "--train_batch_size", "2", "--tiny",
              "--device", "cpu", "--mixed_precision", "no",
              "--dataloader_num_workers", "0", "--seed", "3",
              "--learning_rate", str(LR), "--max_train_steps", "2",
              "--checkpointing_steps", "2"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    args_one = [*common, "--output_dir", one,
                *(a.format(run=one) for a in extra)]
    proc = subprocess.run(
        [sys.executable, "-m", "diffcodec_tpu_torch.cli.train_controlnet",
         *args_one], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    _torchrun(2, ["-m", "diffcodec_tpu_torch.cli.train_controlnet",
                  *common, "--output_dir", two, "--fsdp", "2",
                  *(a.format(run=two) for a in extra)])
    return args_one, one, two


def _check_checkpoints_agree(args_one, one, two):
    """checkpoint-2 of the sharded run is the one-process run's, to the
    sharding limits and to CLI_STEP_REL of the two steps' move from the
    initial masters (the CLI's own, built here from its arguments)."""
    from diffcodec_tpu_torch.cli import train_controlnet

    _, init, _, _ = train_controlnet.build_trainer(
        train_controlnet.parse_args(args_one))
    want, s1 = checkpoint.restore_checkpoint(one)
    got, s2 = checkpoint.restore_checkpoint(two)
    assert s1 == s2 == 2 and got["step"] == 2
    assert set(got["params"]) == set(want["params"])
    for n, w in want["params"].items():
        assert got["params"][n].shape == w.shape
        np.testing.assert_allclose(got["params"][n].numpy(), w.numpy(),
                                   rtol=2e-3, atol=3 * LR, err_msg=n)
    rel = _rel_to_move(got["params"], want["params"], init.params)
    assert rel < CLI_STEP_REL, rel
    for n, w in want["opt_state"]["nu"].items():
        np.testing.assert_allclose(got["opt_state"]["nu"][n].numpy(),
                                   w.numpy(), rtol=2e-3, atol=1e-9,
                                   err_msg=n)
    for k in ("mu", "nu"):
        rel = _rel_to_move(got["opt_state"][k], want["opt_state"][k],
                           init.opt_state[k])
        assert rel < CLI_STEP_REL, (k, rel)
    assert os.listdir(two) == ["checkpoint-2"]


def test_train_controlnet_fsdp2_checkpoint_is_one_process_one(tmp_path):
    """`train_controlnet --fsdp 2` (2 gloo ranks, data 1 x fsdp 2) writes
    the checkpoint of the one-process run."""
    _check_checkpoints_agree(*_train_controlnet_runs(tmp_path))


def test_train_controlnet_fsdp2_fills_the_latent_cache_over_ranks(tmp_path):
    """With `--latent_cache_dir` under torchrun each rank encodes its
    share of the cache: the files equal the one-process run's, bit for
    bit (the same batches of the same samples), and so does the training
    that reads them, to the sharding limits."""
    args_one, one, two = _train_controlnet_runs(
        tmp_path, "--latent_cache_dir", "{run}_cache")
    names = sorted(os.listdir(one + "_cache"))
    assert names == sorted(os.listdir(two + "_cache"))
    assert len([n for n in names if n.startswith("moments_")]) == 4
    for n in names:
        with open(os.path.join(one + "_cache", n), "rb") as f1, \
                open(os.path.join(two + "_cache", n), "rb") as f2:
            assert f1.read() == f2.read(), n
    _check_checkpoints_agree(args_one, one, two)


def test_fsdp_without_torchrun_is_refused(tmp_path, monkeypatch):
    from diffcodec_tpu_torch.cli import train_controlnet, train_distill
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for cli in (train_controlnet, train_distill):
        with pytest.raises(SystemExit, match="torchrun"):
            cli.main(["--index_file", "x", "--output_dir",
                      str(tmp_path), "--fsdp", "2", "--device", "cpu"])


def test_init_distributed_needs_torchrun(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.join_mesh(1, "cpu") is None
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.init_distributed("cpu")
