"""The port's fused dense and MLP ops (``apex_tpu_torch.ops.dense``,
``apex_tpu_torch.ops.mlp``) against the JAX package's, fp32 on the CPU.

The same numpy inputs and weights go through both; forward values and
every gradient (``jax.vjp`` against autograd, one seeded cotangent) agree
within 1e-5 relative and absolute (the measured gap is float32 rounding
of the GEMMs' sums, about 1e-6).  The modules take the Flax modules'
parameters by name: both keep the torch layout ``[out, in]``.  The erf
GeLU of ``fused_dense_gelu_dense`` and the tanh one of BERT's LM head are
pinned against their JAX counterparts and told apart.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_threads import one_torch_thread  # noqa: F401

from apex_tpu.ops import dense as jdense
from apex_tpu.ops import mlp as jmlp
from apex_tpu_torch.ops import dense, mlp

TOL = dict(rtol=1e-5, atol=1e-5)


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) * 0.5 for s in shapes]


def _jax_vjp(fn, args, seed):
    """``fn(*args)`` and its vjp under a seeded cotangent of its shape, in
    one jitted call (eager JAX compiles every small op)."""
    shape = jax.eval_shape(fn, *args).shape
    g = np.random.RandomState(seed).randn(*shape).astype(np.float32)

    @jax.jit
    def run(args, g):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(g)

    out, grads = run(args, jnp.asarray(g))
    return np.asarray(out), jax.device_get(grads), g


def _both(fn_jax, fn_port, arrays, seed=7):
    """Values and gradients of ``fn_jax`` and ``fn_port`` on ``arrays``
    under one seeded cotangent."""
    out, grads, g = _jax_vjp(fn_jax, [jnp.asarray(a) for a in arrays], seed)
    want = (out, [np.asarray(t) for t in grads])
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = fn_port(*leaves)
    got.backward(torch.from_numpy(g))
    return (got.detach().numpy(), [t.grad.numpy() for t in leaves]), want


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_fused_dense_matches_jax(bias):
    x, w, b = _arrays(0, (3, 5, 16), (12, 16), (12,))
    arrays = [x, w, b] if bias else [x, w]
    _close(*_both(jdense.fused_dense, dense.fused_dense, arrays))


def test_fused_dense_gelu_dense_matches_jax():
    arrays = _arrays(1, (4, 16), (24, 16), (24,), (8, 24), (8,))
    _close(*_both(jdense.fused_dense_gelu_dense,
                  dense.fused_dense_gelu_dense, arrays))


def test_dense_gelu_is_erf_and_bert_lm_head_gelu_is_tanh():
    """``fused_dense_gelu_dense`` takes the erf GeLU (the cuBLASLt
    epilogue's) and BERT's LM head Flax's default ``nn.gelu``, the tanh
    approximation; the two differ by up to about 5e-4 on [-4, 4]."""
    x = np.linspace(-4, 4, 257).astype(np.float32)
    t = torch.from_numpy(x)
    erf = F.gelu(t, approximate="none").numpy()
    tanh = F.gelu(t, approximate="tanh").numpy()
    np.testing.assert_allclose(
        erf, np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tanh, np.asarray(fnn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    assert np.abs(erf - tanh).max() > 1e-4
    eye = torch.eye(x.size)
    got = dense.fused_dense_gelu_dense(t[None], eye, None, eye, None)[0]
    np.testing.assert_allclose(got.numpy(), erf, rtol=1e-6, atol=1e-6)


def _module_both(jmod, port, x, seed=11):
    params = jax.device_get(jax.jit(jmod.init)(jax.random.PRNGKey(3),
                                               jnp.asarray(x))["params"])
    port.load_state_dict({k: torch.tensor(np.asarray(v))
                          for k, v in params.items()})

    def jfn(p, xx):
        return jmod.apply({"params": p}, xx)

    out, (gp, gx), g = _jax_vjp(jfn, [params, jnp.asarray(x)], seed)
    xt = torch.tensor(x, requires_grad=True)
    y = port(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[name]),
                                   **TOL, err_msg=name)


@pytest.mark.parametrize("use_bias", [True, False])
def test_fused_dense_module_matches_flax(use_bias):
    (x,) = _arrays(2, (6, 16))
    _module_both(jdense.FusedDense(16, 12, use_bias=use_bias),
                 dense.FusedDense(16, 12, use_bias=use_bias, device="cpu"), x)


def test_fused_dense_gelu_dense_module_matches_flax():
    (x,) = _arrays(3, (2, 5, 16))
    _module_both(jdense.FusedDenseGeluDense(16, 32, 8),
                 dense.FusedDenseGeluDense(16, 32, 8, device="cpu"), x)


@pytest.mark.parametrize("activation", ["none", "relu", "sigmoid"])
@pytest.mark.parametrize("use_bias", [True, False])
def test_mlp_forward_matches_jax(activation, use_bias):
    arrays = _arrays(4, (5, 16), (24, 16), (8, 24), (4, 8), (24,), (8,), (4,))
    n = 3 if use_bias else 0

    def port(x, *wb):
        return mlp.mlp_forward(x, wb[:3], wb[3:3 + n], activation)

    def ref(x, *wb):
        return jmlp.mlp_forward(x, wb[:3], wb[3:3 + n], activation)

    _close(*_both(ref, port, arrays[:4 + n]))


@pytest.mark.parametrize("activation", ["relu", "sigmoid"])
def test_mlp_module_matches_flax(activation):
    (x,) = _arrays(5, (6, 16))
    sizes = [16, 24, 8]
    _module_both(jmlp.MLP(sizes, activation=activation),
                 mlp.MLP(sizes, activation=activation, device="cpu"), x)


def test_mlp_refuses_an_unknown_activation_as_jax():
    x = np.zeros((2, 4), np.float32)
    w = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError):
        jmlp.mlp_forward(jnp.asarray(x), [jnp.asarray(w)], [], "tanh")
    with pytest.raises(ValueError):
        mlp.mlp_forward(torch.from_numpy(x), [torch.from_numpy(w)], [], "tanh")
    with pytest.raises(ValueError):
        mlp.MLP([4, 4], activation="gelu", device="cpu")


def test_parameters_keep_param_dtype_and_compute_in_the_input_dtype():
    m = dense.FusedDense(16, 8, device="cpu")
    assert m.weight.dtype == torch.float32
    y = m(torch.ones(2, 16, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16
    m2 = mlp.MLP([16, 8], param_dtype=torch.bfloat16, device="cpu")
    assert m2.weight_0.dtype == torch.bfloat16
    assert m2(torch.ones(2, 16)).dtype == torch.float32


def test_modules_without_a_device_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: dense.FusedDense(4, 4),
                  lambda: dense.FusedDenseGeluDense(4, 8, 4),
                  lambda: mlp.MLP([4, 4])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
