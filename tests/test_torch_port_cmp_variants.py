"""The port's CMP variants (`models/cmp.py`: the AlexNet backbones,
ShallowNet's /32 strides, the plain and FlowNet decoders) against the JAX
package's, on the CPU.

The name maps of every backbone and decoder entry for entry; eval-mode
bin logits (every scale of the FlowNet decoder) to 1e-4 of their largest
magnitude and the fused flow to 2e-3 px (`test_torch_port_cmp.py`'s
limits), at tiny widths and at full width, from one set of seeded fp32
variables carried across by `weights.load_cmp_params`.  DiffCodec's
resnet50 + skip CMP is `test_torch_port_cmp.py`'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcodec_tpu.models import cmp as jcmp

from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models import cmp
from torch_threads import few_torch_threads

LOGIT_REL = 1e-4
FLOW_ATOL = 2e-3

VARIANTS = [(99, "resnet50", "skip", (1, 2, 4)),
            (99, "resnet50", "plain", (1, 2, 4)),
            (99, "resnet50", "flownet", (1, 2, 4)),
            (99, "alexnet_fcn_32x", "plain", (1,)),
            (9, "alexnet_fcn_8x", "plain", (1, 2, 4, 8)),
            (9, "resnet50", "plain", (2, 8))]


_one_torch_thread = few_torch_threads(1)


@pytest.mark.parametrize("variant", VARIANTS)
def test_name_maps_match_jax_and_cover_the_module(variant):
    assert weights.cmp_name_map(*variant) == jcmp.cmp_name_map(*variant)
    assert (weights.cmp_batch_stats_map(*variant)
            == jcmp.cmp_batch_stats_map(*variant))
    model = cmp.CMP(16, 4, *variant[:1], 50.0, *variant[1:])
    keys = {k for k in model.state_dict()
            if not k.endswith("num_batches_tracked")}
    mapped = [t for t, _, _ in sum(weights.cmp_maps(model), [])]
    assert len(mapped) == len(set(mapped)) == len(keys)
    assert set(mapped) == keys


@pytest.mark.parametrize("kwargs, match", [
    (dict(backbone="alexnet_fcn_32x", decoder="skip"), "no skip features"),
    (dict(backbone="alexnet_fcn_8x", decoder="flownet"), "no skip features"),
    (dict(backbone="vgg16"), "unknown backbone 'vgg16'"),
    (dict(decoder="bogus"), "unknown decoder 'bogus'"),
])
def test_constructor_rejects_what_jax_rejects(kwargs, match):
    with pytest.raises(ValueError, match=match):
        jcmp.CMP(**kwargs).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)),
                                jnp.zeros((1, 64, 64, 4)))
    with pytest.raises(ValueError, match=match):
        cmp.CMP(**kwargs)


def test_conv_transpose_kernels_round_trip():
    """`convT_kernel` both ways: a FlowNet decoder's torch state dict ->
    the flax tree -> torch again, bit for bit, with flax's [kh, kw, out,
    in] layout for the transposed convs."""
    model = cmp.CMP(16, 4, 9, decoder="flownet")
    pmap, _ = weights.cmp_maps(model)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = weights.import_state_dict(sd, pmap)
    k = tree["flow_decoder"]["deconv8"]["kernel"]
    assert k.shape == (4, 4, 128, 256)
    back = weights.export_state_dict(tree, pmap)
    for name, value in back.items():
        np.testing.assert_array_equal(value, sd[name])


def _randomize(shapes, seed):
    """Seeded fp32 variables: kernels ~ N(0, 1.3 / fan_in), BatchNorm
    scales and variances in [0.5, 1.5], small biases and means."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            fan_in = int(np.prod(p.shape[:-1]))
            v = rng.standard_normal(p.shape) * np.sqrt(1.3 / fan_in)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, p.shape)
        else:
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


FULL = dict(img_enc_dim=256, sparse_enc_dim=16, nbins=99)
TINY = dict(img_enc_dim=16, sparse_enc_dim=4, nbins=9)
CASES = [
    # (widths, variant, sizes): full width at 64 and 72 x 104 where the
    # stride allows (alexnet_fcn_32x needs 128)
    (FULL, dict(decoder="plain"), [(64, 64), (72, 104)]),
    (FULL, dict(decoder="flownet"), [(64, 64), (72, 104)]),
    (FULL, dict(backbone="alexnet_fcn_32x", decoder="plain", combo=(1,)),
     [(128, 128), (160, 224)]),
    (TINY, dict(decoder="plain", combo=(1, 8)), [(72, 104)]),
    (TINY, dict(decoder="flownet"), [(72, 104)]),
    (TINY, dict(backbone="alexnet_fcn_8x", decoder="plain",
                combo=(1, 2, 4)), [(64, 96)]),
]


@pytest.mark.parametrize("widths, variant, sizes", CASES)
def test_eval_logits_and_flow_match_jax(widths, variant, sizes):
    jmodel = jcmp.CMP(**widths, **variant)
    H0, W0 = sizes[0]
    variables = _randomize(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, H0, W0, 3)),
        jnp.zeros((1, H0, W0, 4))), 5)
    model = cmp.CMP(**widths, **variant).eval()
    weights.load_cmp_params(model, variables)
    logits_fn = jax.jit(lambda i, s: jmodel.apply(variables, i, s,
                                                  method=jmodel.logits))
    flow_fn = jax.jit(jmodel.apply)
    for H, W in sizes:
        image, sparse = _inputs(H, W, H + W)
        want_logits = logits_fn(image, sparse)
        want = np.asarray(flow_fn(variables, image, sparse))
        with torch.no_grad():
            ti, ts = torch.from_numpy(image), torch.from_numpy(sparse)
            got_logits = model.logits(ti, ts)
            got = model(ti, ts).numpy()
        if variant.get("decoder") == "flownet":
            assert len(got_logits) == len(want_logits) == 4
            assert got_logits[0].shape[1:3] == (H, W)
        else:
            got_logits, want_logits = [got_logits], [want_logits]
        for g, w in zip(got_logits, want_logits):
            w = np.asarray(w)
            assert g.shape == w.shape
            assert w.std() > 0.1  # not flat: the comparison means something
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=LOGIT_REL * np.abs(w).max())
        assert got.shape == want.shape == (1, H, W, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_ATOL)


def test_train_mode_batchnorm_is_flaxs():
    """One BatchNorm in training mode: the output from the batch's mean
    and biased fast variance, and the running statistics moved as 0.99
    running + 0.01 batch, against flax's `nn.BatchNorm` (torch's own
    would keep 0.9 running + 0.1 times the unbiased variance)."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 7, 16)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, 16).astype(np.float32)
    mean0 = rng.uniform(-0.1, 0.1, 16).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False)
    want, state = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}, x,
        mutable=["batch_stats"])
    layer = cmp.BatchNorm(16).train()
    layer.load_state_dict({"weight": torch.from_numpy(scale),
                           "bias": torch.from_numpy(bias),
                           "running_mean": torch.from_numpy(mean0),
                           "running_var": torch.from_numpy(var0),
                           "num_batches_tracked": torch.tensor(0)})
    got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for k, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(layer, name).numpy(),
                                   np.asarray(state["batch_stats"][k]),
                                   rtol=1e-6)
