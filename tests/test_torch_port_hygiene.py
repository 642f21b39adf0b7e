"""The port imports on a machine without JAX.

The card's machine has PyTorch, numpy, scipy and einops but no jax, flax,
optax, PIL, safetensors, matplotlib, transformers, triton or PyYAML, and
the port must not lean on the JAX package.  A subprocess installs an import hook that
refuses those modules, then imports every module of `diffcodec_tpu_torch`
(the codec's among them: its JPEG reads import PIL inside functions; the
residual stage's and the CLIP tokenizer's; the checkpoint loaders, the
evaluation layer, whose plots import matplotlib inside functions, the
distillation trainer, the dataset loader (PIL inside its image read), the
prefetcher, the metrics logger, the PNG writer, the in-training
validation and the CLIs, the training, export, drift, weights-day and
figure ones among them; the CMP's trainer, its configs (PyYAML inside the
YAML loader) and CLI; the mesh and its dry run), `chip_smoke` and the
port's
scripts, `scripts/profile_torch_decode.py` (which also profiles the
residual training points), `scripts/conv_kernel_breakdown.py`,
`scripts/conv_kernel_ab.py`, `scripts/attention_bwd_ab.py`,
`scripts/attention_fwd_ab.py`, `scripts/splat_kernel_ab.py` and
`scripts/torch_distill_loss_seeds.py` (without running them).  The parity
tests at SD-1.5's depth, at the bf16 islands and over the 30-step decode,
and the recorder they share (`tests/decode_tape.py`), the training and
the distillation steps' comparisons (`tests/train_parity.py`,
`tests/distill_parity.py`) and the distillation loss's seeds
(`tests/distill_loss_seeds.py`) import JAX for their reference side;
their port-side imports run under the same hook.
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "diffcodec_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "PIL", "safetensors",
           "matplotlib", "transformers", "triton", "yaml", "diffcodec_tpu")

_HOOK = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = set(sys.argv[1].split(","))


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
"""

_CHILD = _HOOK + r"""
import diffcodec_tpu_torch
names = ["diffcodec_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(diffcodec_tpu_torch.__path__,
                                          "diffcodec_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, "scripts")
import profile_torch_decode
import conv_kernel_breakdown
import conv_kernel_ab
import attention_bwd_ab
import attention_fwd_ab
import splat_kernel_ab
import torch_distill_loss_seeds
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("imported", len(names), "modules:", " ".join(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, ",".join(BLOCKED)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n = int(re.search(r"imported (\d+) modules", proc.stdout).group(1))
    assert n >= 15  # the package, its subpackages and every module
    # the codec's decode path, whose JPEG reads import PIL inside
    # functions, and the residual second stage with its text encoder
    for name in ("codec.runner", "codec.bits", "codec.gop",
                 "codec.sparse_flow", "models.cmp", "sampling.tiled",
                 "ops.tiling", "utils", "utils.tokenizer",
                 "models.clip_text", "models.unet2d", "train.residue",
                 "utils.safetensors_io", "utils.flo_io", "models.weights",
                 "models.i3d", "train.lpips", "codec.anchors",
                 "eval.metrics", "eval.inception", "eval.frechet",
                 "eval.codec_eval", "eval.bd_rate", "eval.anchors_data",
                 "eval.plots", "eval.visual_study", "eval.freq_analysis",
                 "cli.run_codec", "cli.rd_sweep", "train.distill",
                 "train.dataset", "train.prefetch", "utils.logging",
                 "cli.train_distill", "cli.train_residual",
                 "cli.distill_eval", "utils.png_io", "train.validation",
                 "cli.train_controlnet", "cli.export_checkpoint",
                 "cli.approx_drift", "cli.weights_day", "cli.make_figures",
                 "train.cmp_train", "train.cmp_config", "cli.train_cmp",
                 "parallel.mesh", "parallel.dryrun"):
        assert f"diffcodec_tpu_torch.{name}" in proc.stdout.split(), name


def test_kernel_sources_include_no_torch_headers():
    sources = sorted(PKG.glob("csrc/*.cu*"))
    assert {p.name for p in sources} >= {"attention.cu", "splat.cu",
                                         "conv3x3.cu", "hopper.cuh"}
    for p in sources:
        includes = re.findall(r'#\s*include\s*[<"]([^>"]+)[>"]',
                              p.read_text())
        assert includes, p
        assert not [i for i in includes if i.startswith(("torch/", "ATen/",
                                                         "c10/"))], p


def test_port_sources_name_no_jax():
    for p in PKG.rglob("*.py"):
        text = p.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|flax|diffcodec_tpu)\b",
                             text, re.M), p


# the parity tests at SD-1.5's depth, at the bf16 islands and over the
# 30-step decode, the recorder they share, and the training step's
# comparison at SD-1.5's width and depth: JAX's side is their own, the
# port's side comes from the port alone
PARITY_TESTS = ("test_torch_port_fulldepth.py",
                "test_torch_port_bf16_sites.py",
                "test_torch_port_longrun.py",
                "test_torch_port_fulldepth_longrun.py",
                "decode_tape.py", "train_parity.py", "distill_parity.py",
                "distill_loss_seeds.py")
PORT_SIDE = ("diffcodec_tpu_torch", "chip_smoke")


def _port_side_imports(path: pathlib.Path) -> list:
    """The import statements of a test file that name the port's side."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            continue
        if any(n.split(".")[0] in PORT_SIDE for n in names):
            assert all(n.split(".")[0] in PORT_SIDE for n in names), (
                path.name, ast.unparse(node))
            out.append(ast.unparse(node))
    return out


def test_parity_tests_import_the_port_side_without_jax():
    """Every port-side import of the full-depth, per-site and 30-step
    tests and of their recorder runs with jax, flax and the JAX package
    refused: what they hold against JAX is the port's own code, not a
    module that leans on the reference."""
    lines = []
    for name in PARITY_TESTS:
        found = _port_side_imports(REPO / "tests" / name)
        assert found, name
        lines += found
    child = _HOOK + "\n".join(lines) + r"""
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("ok")
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", child, ",".join(BLOCKED)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.split() == ["ok"], (
        proc.stderr)
