"""The port's CMP (the sparse-mode flow densifier) against the JAX
package's, on the CPU.

DiffCodec's configuration at full width (resnet50 backbone, skip decoder,
99 bins over +-50 px), fp32 on both sides, from one set of seeded weights
and BatchNorm running statistics carried across by
`weights.load_cmp_params`.  Both sides run fp32 convolutions in their own
summation orders (XLA's and oneDNN's), ~1e-7 relative a layer, through 60
layers: the bin logits are held to 1e-4 of their largest magnitude and the
flow, whose bin centres span 100 px, to 2e-3 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcodec_tpu.codec import runner as jrunner
from diffcodec_tpu.models import cmp as jcmp

from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.codec import runner
from diffcodec_tpu_torch.models import cmp
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(1)

LOGIT_REL = 1e-4
FLOW_ATOL = 2e-3


@pytest.mark.parametrize("name", ["cmp_name_map", "cmp_batch_stats_map"])
def test_name_maps_match_jax(name):
    assert getattr(weights, name)() == getattr(jcmp, name)()


def test_state_dict_keys_are_the_maps_torch_names():
    keys = {k for k in cmp.CMP().state_dict()
            if not k.endswith("num_batches_tracked")}
    mapped = [t for t, _, _ in weights.cmp_name_map()
              + weights.cmp_batch_stats_map()]
    assert len(mapped) == len(set(mapped)) == len(keys)
    assert set(mapped) == keys


def test_bin_centres_are_jax_jitted_ones():
    """A one-hot softmax returns one bin's centre exactly: JAX's jitted
    fuse_discrete_flow, bin by bin, against the port's centres."""
    nb = 99
    logits = np.full((1, 1, nb, 2 * nb), -1e30, np.float32)
    idx = np.arange(nb)
    logits[0, 0, idx, idx] = 0.0
    logits[0, 0, idx, nb + idx] = 0.0
    want = np.asarray(jax.jit(jcmp.fuse_discrete_flow)(jnp.asarray(logits)))
    got = cmp.fuse_discrete_flow(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got[0, 0, :, 0], cmp.bin_centres())
    np.testing.assert_array_equal(got, want)


def test_fuse_discrete_flow_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 5, 7, 198)) * 3).astype(np.float32)
    want = np.asarray(jax.jit(jcmp.fuse_discrete_flow)(jnp.asarray(logits)))
    got = cmp.fuse_discrete_flow(torch.from_numpy(logits)).numpy()
    # 99-term fp32 sums in another order, over centres up to 50 px
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _randomize(shapes, seed):
    """Seeded float32 values for the CMP's variables: kernels ~ N(0, 1.3 /
    fan_in), which leaves the bin logits a spread of a few units after 60
    layers (1 / fan_in shrinks them to ~0.2, 2 / fan_in blows them up to
    ~1000), BatchNorm scales and variances in [0.5, 1.5], small biases and
    means."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            fan_in = int(np.prod(p.shape[:-1]))
            v = rng.standard_normal(p.shape) * np.sqrt(1.3 / fan_in)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, p.shape)
        else:  # bias, mean
            v = rng.uniform(-0.1, 0.1, p.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(H, W, seed):
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    sparse = np.zeros((1, H, W, 4), np.float32)
    ys, xs = rng.integers(0, H, 12), rng.integers(0, W, 12)
    sparse[0, ys, xs, :2] = rng.uniform(-20, 20, (12, 2))
    sparse[0, ys, xs, 2:] = 1.0
    return image, sparse


@pytest.fixture(scope="module")
def models():
    jmodel = jcmp.CMP()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 64, 64, 4)))
    variables = _randomize(shapes, 5)
    model = cmp.CMP().eval()
    weights.load_cmp_params(model, variables)
    return jmodel, variables, model


@pytest.mark.parametrize("H,W", [(64, 64), (72, 104)])
def test_cmp_matches_jax(models, H, W):
    """Full width, fp32.  At 72 x 104 the /8 map is 9 x 13, so the
    decoder's max-pools of 2, 4 and 8 floor (4 x 6, 2 x 3, 1 x 1) and the
    align_corners resizes stretch uneven grids."""
    jmodel, variables, model = models
    image, sparse = _inputs(H, W, H)
    want_logits = np.asarray(jax.jit(
        lambda i, s: jmodel.apply(variables, i, s, method=jmodel.logits))(
            image, sparse))
    want = np.asarray(jax.jit(jmodel.apply)(variables, image, sparse))
    with torch.no_grad():
        ti, ts = torch.from_numpy(image), torch.from_numpy(sparse)
        got_logits = model.logits(ti, ts).numpy()
        got = model(ti, ts).numpy()
    assert got_logits.shape == want_logits.shape == (1, H // 2, W // 2, 198)
    assert got.shape == want.shape == (1, H, W, 2)
    # neither flat nor saturated: the comparison means something
    assert 0.5 < want_logits.std() < 20
    assert want.std() > 0.5
    np.testing.assert_allclose(
        got_logits, want_logits, rtol=0,
        atol=LOGIT_REL * np.abs(want_logits).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_ATOL)


def test_cmp_densifier_matches_jax(models):
    jmodel, variables, model = models
    image, sparse = _inputs(64, 64, 3)
    mask = np.repeat(sparse[0, ..., 2:3], 2, -1).astype(np.int32)
    args = (sparse[0, ..., :2], mask, image[0])
    want = jrunner.make_cmp_densifier(jmodel, variables)(*args)
    got = runner.make_cmp_densifier(model, device="cpu")(*args)
    assert got.shape == (64, 64, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_ATOL)
