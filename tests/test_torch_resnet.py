"""The port's ResNet, SyncBatchNorm and image batches against the JAX
package's (fp32, narrow widths).

- ``"SAME"`` padding: the 7x7/2 stem and the 3x3/2 max-pool at 32 x 32
  pad (2, 3) and (0, 1) as Flax does, bit for bit; the symmetric
  ``F.conv2d(padding=3)`` / ``F.max_pool2d(padding=1)`` give other
  numbers (pinned);
- ``SyncBatchNorm`` forward, backward (x, z, scale, bias) and running
  statistics against the Flax module, with ``z``/``fuse_relu``,
  ``track_running_stats=False`` and the running average, at 1e-5;
- each kind of block (a projection with stride 1 and 2, an identity
  block, the basic block), fed the same input, forward and backward
  against the Flax block at 1e-5 (relative to the largest element);
- the whole narrow ResNet-50 (``num_filters=8``) through
  ``from_flax_resnet``: logits within 1e-2 and the global gradient norm
  within 2e-2, relative (measured 1.0e-2).  Over 53 BN layers of a batch
  of 8 at 1 x 1 to 16 x 16 pixels the statistics' fp32 rounding grows:
  the full-width JAX model's gradient norm moves by up to 3.8e-3 from
  weights moved by one ulp (``test_torch_l1_rn50.py``); the blocks above
  hold each layer tightly;
- the weights both ways (and a checkpoint of either package restored by
  the other, bit for bit), the O2/O3 casts by the amp name patterns, and
  the synthetic batches and ``normalize_on_device``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_threads import one_torch_thread  # noqa: F401

import flax.linen as nn
from apex_tpu import amp as jamp
from apex_tpu.data import image_folder as jdata
from apex_tpu.models import resnet as jres
from apex_tpu.parallel.sync_batchnorm import SyncBatchNorm as JaxSyncBN
from apex_tpu_torch import amp
from apex_tpu_torch.data import image_folder as tdata
from apex_tpu_torch.models import resnet as tres
from apex_tpu_torch.parallel import SyncBatchNorm
from apex_tpu_torch.testing.l1 import apply_policy


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _numpy(tree):
    """A tree of CPU tensors (``to_flax_resnet``'s) as numpy, bf16 leaves
    as fp32 (exact)."""
    return jax.tree_util.tree_map(
        lambda t: (t.float() if t.dtype == torch.bfloat16 else t).numpy(),
        tree)


def _dtype(x):
    """The dtype's name, ``"bfloat16"``, ``"float32"``, of a numpy array
    or a tensor."""
    return str(x.dtype).removeprefix("torch.")


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def test_same_padding_matches_flax_and_the_symmetric_pads_do_not():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    conv = nn.Conv(8, (7, 7), (2, 2), use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), x)
    want = np.asarray(conv.apply(v, x))
    stem = tres.Conv(3, 8, 7, 2, device="cpu")
    with torch.no_grad():
        stem.weight.copy_(torch.tensor(
            np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
    got = _nhwc(stem(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    symmetric = _nhwc(F.conv2d(_nchw(x), stem.weight, stride=2, padding=3))
    assert np.abs(symmetric - want).max() > 1e-2
    assert tres.same_pads(32, 7, 2) == (2, 3)

    h = rng.randn(2, 16, 16, 8).astype(np.float32)
    want = np.asarray(nn.max_pool(h, (3, 3), strides=(2, 2), padding="SAME"))
    np.testing.assert_array_equal(_nhwc(tres.max_pool_same(_nchw(h))), want)
    symmetric = _nhwc(F.max_pool2d(_nchw(h), 3, 2, padding=1))
    assert np.abs(symmetric - want).max() > 1e-1
    assert tres.same_pads(16, 3, 2) == (0, 1)
    assert tres.same_pads(224, 7, 2) == (2, 3)


BN_CASES = {
    "plain": dict(kw={}, z=False, train=True),
    "relu_residual": dict(kw=dict(fuse_relu=True), z=True, train=True),
    "no_running_stats": dict(kw=dict(track_running_stats=False), z=False,
                             train=True),
    "running_average": dict(kw=dict(fuse_relu=True), z=False, train=False),
}


@pytest.mark.parametrize("case", list(BN_CASES))
def test_sync_batchnorm_matches_flax(case):
    c = BN_CASES[case]
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 5, 5, 6) * 3 + 1).astype(np.float32)
    z = rng.randn(4, 5, 5, 6).astype(np.float32) if c["z"] else None
    g = rng.randn(4, 5, 5, 6).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(6)).astype(np.float32)
    bias = (0.1 * rng.randn(6)).astype(np.float32)
    stats = {"running_mean": (0.1 * rng.randn(6)).astype(np.float32),
             "running_var": (1 + 0.1 * rng.rand(6)).astype(np.float32)}
    jm = JaxSyncBN(6, momentum=0.2, **c["kw"])
    params = {"scale": scale, "bias": bias}
    variables = {"params": params, "batch_stats": stats}

    def f(params, x, z):
        y, mut = jm.apply({"params": params, "batch_stats": stats}, x, z=z,
                          use_running_average=not c["train"],
                          mutable=["batch_stats"])
        return jnp.sum(y * g), mut
    (_, mut), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(params, x, z)
    want_y = jm.apply(variables, x, z=z, use_running_average=not c["train"],
                      mutable=["batch_stats"])[0]

    m = SyncBatchNorm(6, momentum=0.2, device="cpu", **c["kw"])
    m.load_state_dict({**{k: torch.from_numpy(v) for k, v in params.items()},
                       **{k: torch.from_numpy(v) for k, v in stats.items()}})
    m.train(c["train"])
    xt = _nchw(x).requires_grad_()
    zt = _nchw(z).requires_grad_() if z is not None else None
    y = m(xt, z=zt)
    (y * _nchw(g)).sum().backward()
    assert _rel(_nhwc(y), want_y) < 1e-5
    assert _rel(_nhwc(xt.grad), grads[1]) < 1e-5
    if z is not None:
        assert _rel(_nhwc(zt.grad), grads[2]) < 1e-5
    assert _rel(m.scale.grad.numpy(), grads[0]["scale"]) < 1e-5
    assert _rel(m.bias.grad.numpy(), grads[0]["bias"]) < 1e-5
    for k, v in mut["batch_stats"].items():
        assert _rel(getattr(m, k).numpy(), v) < 1e-6, k


# block kind -> (Flax class, features, strides, input channels)
BLOCKS = {
    "bottleneck_projection": (jres.BottleneckBlock, 4, 1, 8),
    "bottleneck_strided": (jres.BottleneckBlock, 8, 2, 16),
    "bottleneck_identity": (jres.BottleneckBlock, 4, 1, 16),
    "basic_strided": (jres.BasicBlock, 8, 2, 4),
}


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_block_matches_flax(kind):
    cls, features, strides, cin = BLOCKS[kind]
    rng = np.random.RandomState(2)
    x = rng.randn(4, 8, 8, cin).astype(np.float32)
    jb = cls(features, strides=strides)
    v = jax.jit(lambda k: jb.init(k, x))(jax.random.PRNGKey(3))

    def f(p, x):
        y, _ = jb.apply({"params": p, "batch_stats": v["batch_stats"]}, x,
                        mutable=["batch_stats"])
        return y

    def f_and_vjp(p, x, g):
        y, vjp = jax.vjp(f, p, x)
        return (y, *vjp(g))
    g = rng.randn(*jax.eval_shape(f, v["params"], x).shape).astype(
        np.float32)
    want, gp, gx = jax.jit(f_and_vjp)(v["params"], x, g)

    port_cls = (tres.BottleneckBlock if cls is jres.BottleneckBlock
                else tres.BasicBlock)
    tb = port_cls(cin, features, strides=strides, device="cpu")
    tb.load_state_dict(tres.from_flax_resnet(jax.tree_util.tree_map(
        np.asarray, dict(v))))
    tb.train()
    xt = _nchw(x).requires_grad_()
    y = tb(xt)
    (y * _nchw(g)).sum().backward()
    assert _rel(_nhwc(y), want) < 1e-5
    assert _rel(_nhwc(xt.grad), gx) < 1e-5
    got = _numpy(tres.to_flax_resnet(
        {n: p.grad for n, p in tb.named_parameters()}))
    for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(gp),
            jax.tree_util.tree_leaves(got["params"])):
        assert _rel(b, a) < 1e-4, jax.tree_util.keystr(path)


@pytest.fixture(scope="module")
def narrow():
    """The narrow Flax ResNet-50, its variables, and one train-mode step's
    logits, gradients and new statistics."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=(8,))
    model = jres.ResNet50(num_classes=10, num_filters=8)
    v = jax.jit(lambda k: model.init(k, x[:2], train=True))(
        jax.random.PRNGKey(0))

    def loss_fn(p, stats):
        logits, mut = model.apply({"params": p, "batch_stats": stats}, x,
                                  train=True, mutable=["batch_stats"])
        loss = -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(8), y])
        return loss, (logits, mut["batch_stats"])
    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], v["batch_stats"])
    eval_logits = jax.jit(lambda v: model.apply(v, x, train=False))(v)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(x=x, y=y, variables=to_np(dict(v)), loss=float(loss),
                logits=np.asarray(logits), grads=to_np(grads),
                stats=to_np(stats), eval_logits=np.asarray(eval_logits))


def test_narrow_resnet50_matches_flax(narrow):
    m = tres.ResNet50(num_classes=10, num_filters=8, device="cpu")
    m.load_state_dict(tres.from_flax_resnet(narrow["variables"]))
    m.train()
    logits = m(_nchw(narrow["x"]))
    loss = -torch.log_softmax(logits, -1)[torch.arange(8),
                                          torch.from_numpy(narrow["y"])]
    loss.mean().backward()
    assert _rel(logits.detach().numpy(), narrow["logits"]) < 1e-2
    np.testing.assert_allclose(float(loss.mean().detach()), narrow["loss"],
                               rtol=1e-4)
    got = _numpy(tres.to_flax_resnet(
        {n: p.grad for n, p in m.named_parameters()}))
    norm = lambda t: np.sqrt(sum(np.sum(np.square(a, dtype=np.float64))  # noqa
                                 for a in jax.tree_util.tree_leaves(t)))
    np.testing.assert_allclose(norm(got["params"]), norm(narrow["grads"]),
                               rtol=2e-2)
    stats = _numpy(tres.to_flax_resnet({
        k: v for k, v in m.state_dict().items()
        if "running" in k}))["batch_stats"]
    for a, b in zip(jax.tree_util.tree_leaves(stats),
                    jax.tree_util.tree_leaves(narrow["stats"])):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    m.eval()
    with torch.no_grad():
        m.load_state_dict(tres.from_flax_resnet(narrow["variables"]))
        assert _rel(m(_nchw(narrow["x"])).numpy(), narrow["eval_logits"]) \
            < 1e-4


def test_weights_round_trip_both_ways(narrow):
    v = narrow["variables"]
    state = tres.from_flax_resnet(v)
    m = tres.ResNet50(num_classes=10, num_filters=8, device="cpu", seed=None)
    m.load_state_dict(state)               # every key, every shape
    back = _numpy(tres.to_flax_resnet(m.state_dict()))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)
    # an O2-cast tree keeps its bf16 kernels both ways
    cast = jax.tree_util.tree_map(np.asarray, jamp.O2.cast_to_param(
        jax.tree_util.tree_map(jnp.asarray, v["params"])))
    state = tres.from_flax_resnet({"params": cast})
    assert state["conv_init.weight"].dtype == torch.bfloat16
    assert state["bn_init.scale"].dtype == torch.float32
    again = tres.to_flax_resnet(state)["params"]
    for a, b in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(cast)):
        assert _dtype(a) == _dtype(b)
        np.testing.assert_array_equal(a.float().numpy(),
                                      b.astype(np.float32))


@pytest.mark.parametrize("level", ["O2", "O3"])
def test_policy_casts_the_parameters_as_jax(level, narrow):
    """The port's module names hit the amp norm patterns as the Flax paths
    do: under O2 the BN scale and bias stay fp32, the convolutions and
    the head go bf16; under O3 everything goes bf16."""
    want = jax.tree_util.tree_map(
        np.asarray, getattr(jamp, level).cast_to_param(
            jax.tree_util.tree_map(jnp.asarray,
                                   narrow["variables"]["params"])))
    m = tres.ResNet50(num_classes=10, num_filters=8, device="cpu", seed=None)
    apply_policy(m, getattr(amp, level))
    got = tres.to_flax_resnet(dict(m.named_parameters()))["params"]
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        assert _dtype(a) == _dtype(b), jax.tree_util.keystr(path)


def test_synthetic_batches_and_normalization_match_jax():
    for (xj, yj), (xt, yt), _ in zip(
            jdata.synthetic_image_batches(4, 16, 10, seed=3),
            tdata.synthetic_image_batches(4, 16, 10, seed=3), range(3)):
        np.testing.assert_array_equal(xj, xt)
        np.testing.assert_array_equal(yj, yt)
        assert yt.dtype == np.int32 and xt.dtype == np.uint8
    for dtype, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jnp.asarray(jdata.normalize_on_device(
            jnp.asarray(xj), dtype=jdt), jnp.float32))
        got = tdata.normalize_on_device(torch.from_numpy(xt), dtype=dtype)
        assert got.dtype == (dtype or torch.float32)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=1e-6 if dtype is None else 1e-2,
                                   atol=1e-6 if dtype is None else 1e-2)
    assert tdata.IMAGENET_MEAN == jdata.IMAGENET_MEAN
    assert tdata.IMAGENET_STD == jdata.IMAGENET_STD


def test_a_checkpoint_of_either_package_restores_in_the_other(narrow,
                                                              tmp_path):
    """The narrow ResNet-50's variables saved by one package's
    ``save_checkpoint`` and restored by the other's, bit for bit: the
    port's state goes through ``to_flax_resnet`` on the way out and
    ``from_flax_resnet`` on the way in."""
    from apex_tpu import checkpoint as jckpt
    from apex_tpu_torch import checkpoint as tckpt

    v = narrow["variables"]
    jtree = jax.tree_util.tree_map(jnp.asarray, v)
    jckpt.save_checkpoint(str(tmp_path / "jax.npz"), jtree, step=3)
    like = tres.to_flax_resnet(tres.ResNet50(
        num_classes=10, num_filters=8, device="cpu").state_dict())
    got, step = tckpt.restore_checkpoint(str(tmp_path / "jax.npz"), like)
    assert step == 3
    m = tres.ResNet50(num_classes=10, num_filters=8, device="cpu", seed=None)
    m.load_state_dict(tres.from_flax_resnet(got))
    want = tres.from_flax_resnet(v)
    for k, t in m.state_dict().items():
        assert torch.equal(t, want[k]), k

    tckpt.save_checkpoint(str(tmp_path / "port.npz"),
                          tres.to_flax_resnet(m.state_dict()), step=4)
    back, step = jckpt.restore_checkpoint(str(tmp_path / "port.npz"), jtree)
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(np.asarray(a), b)
