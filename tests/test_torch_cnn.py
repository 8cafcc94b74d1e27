"""The port's VGG model path (repro_torch.models.cnn) against the JAX
package's (repro.models.cnn): the JAX initialiser's weights are carried
across with ``params_from_jax`` and both packages get the same numpy
inputs. On the CPU every conv of the port takes the kernel's plain version."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import netinfo as jax_netinfo  # noqa: E402
from repro.models import cnn as jax_cnn  # noqa: E402
from repro_torch.core import netinfo  # noqa: E402
from repro_torch.models import cnn  # noqa: E402


def _tiny_net(ni):  # tests/test_cnn_hybrid.py::_tiny_net
    b = ni._B("tiny", 16, 16, 8)
    b.conv(8, 3).conv(8, 3).pool(2).conv(16, 3)
    return b.done()


def _group_net(ni):  # examples/hybrid_vgg_pipeline.py: 4 x conv(32) head, pool, 2 x conv(64)
    b = ni._B("vgg_group", 32, 32, 32)
    for _ in range(4):
        b.conv(32, 3)
    b.pool(2)
    b.conv(64, 3).conv(64, 3)
    return b.done()


def _both(seed, jnet, x_shape, dtype=jnp.float32):
    """JAX params and input, and the same values as port tensors on the CPU."""
    params = jax_cnn.init_vgg(jax.random.key(seed), jnet, dtype)
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(x_shape), dtype)
    tparams = cnn.params_from_jax([None if p is None else np.asarray(p) for p in params],
                                  device="cpu")
    tx = torch.from_numpy(np.array(x, np.float32)).to(tparams[0].dtype)
    return params, x, tparams, tx


@pytest.mark.parametrize("make", [_tiny_net, _group_net,
                                  lambda ni: ni.vgg16(224),
                                  lambda ni: ni.vgg16(32, extra_per_group=1),
                                  lambda ni: ni.vgg19(224)])
def test_netinfo_copy_matches_reference(make):
    ours, ref = make(netinfo), make(jax_netinfo)
    assert [dataclasses.astuple(l) for l in ours.layers] == \
        [dataclasses.astuple(l) for l in ref.layers]
    assert [l.macs for l in ours.layers] == [l.macs for l in ref.layers]
    assert (ours.name, ours.input_hw, ours.input_c, ours.total_ops) == \
        (ref.name, ref.input_hw, ref.input_c, ref.total_ops)
    assert ours.major_indices == ref.major_indices


def test_forward_matches_jax_pallas_path():
    params, x, tparams, tx = _both(0, _tiny_net(jax_netinfo), (1, 8, 16, 16))
    ref = jax_cnn.forward(params, _tiny_net(jax_netinfo), x, use_pallas=True)
    out = cnn.forward(tparams, _tiny_net(netinfo), tx)
    assert out.shape == (1, 16, 8, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_vgg16_forward_matches_jax():
    params, x, tparams, tx = _both(1, jax_netinfo.vgg16(32), (2, 3, 32, 32))
    ref = jax_cnn.forward(params, jax_netinfo.vgg16(32), x, use_pallas=False)
    out = cnn.forward(tparams, netinfo.vgg16(32), tx)
    assert out.shape == (2, 512, 1, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_hybrid_forward_matches_jax():
    plan = (4, 2)
    params, x, tparams, tx = _both(1, jax_netinfo.vgg16(32), (2, 3, 32, 32))
    ref = jax_cnn.hybrid_forward(params, jax_netinfo.vgg16(32), x,
                                 jax_cnn.HybridPlan(*plan), mesh=None)
    for pipelined in (False, True):  # the head holds a pool: sequential either way
        out = cnn.hybrid_forward(tparams, netinfo.vgg16(32), tx, cnn.HybridPlan(*plan),
                                 pipelined=pipelined)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_pipelined_head_matches_jax_forward(monkeypatch):
    params, x, tparams, tx = _both(0, _group_net(jax_netinfo), (8, 32, 32, 32))
    ref = np.asarray(jax_cnn.forward(params, _group_net(jax_netinfo), x))
    calls = []
    real = cnn.pipeline_apply
    monkeypatch.setattr(cnn, "pipeline_apply",
                        lambda *a: calls.append(1) or real(*a))
    out = cnn.hybrid_forward(tparams, _group_net(netinfo), tx, cnn.HybridPlan(4, 4),
                             pipelined=True)
    assert calls, "a homogeneous head must go through pipeline_apply"
    assert float(np.abs(out.numpy() - ref).max()) < 1e-4


def test_bf16_forward_matches_jax():
    params, x, tparams, tx = _both(0, _tiny_net(jax_netinfo), (1, 8, 16, 16),
                                   dtype=jnp.bfloat16)
    assert tparams[0].dtype == torch.bfloat16 and tx.dtype == torch.bfloat16
    ref = jax_cnn.forward(params, _tiny_net(jax_netinfo), x, use_pallas=True)
    out = cnn.forward(tparams, _tiny_net(netinfo), tx)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_default_device_is_cuda():
    net = _tiny_net(netinfo)
    arrays = [None if p is None else np.asarray(p)
              for p in jax_cnn.init_vgg(jax.random.key(0), _tiny_net(jax_netinfo))]
    if torch.cuda.is_available():
        params = cnn.init_vgg(net, generator=torch.Generator(device="cuda"))
        assert all(p is None or p.is_cuda for p in params)
        assert all(p is None or p.is_cuda for p in cnn.params_from_jax(arrays))
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            cnn.init_vgg(net, generator=torch.Generator())
        with pytest.raises(RuntimeError, match="CUDA"):
            cnn.params_from_jax(arrays)


def test_init_vgg_shapes_and_scale():
    net = netinfo.vgg16(32)
    params = cnn.init_vgg(net, generator=torch.Generator().manual_seed(0), device="cpu",
                          dtype=torch.bfloat16)
    for p, l in zip(params, net.layers):
        if l.kind == "pool":
            assert p is None
            continue
        assert p.shape == (l.k, l.c, l.r, l.s) and p.dtype == torch.bfloat16
    # He normal: std sqrt(2 / fan_in) on the 512-channel layers
    assert abs(params[-2].float().std().item() / (2 / (512 * 9)) ** 0.5 - 1) < 0.05


def test_pool_in_pipelined_head_runs_sequentially(monkeypatch):
    """A head of one conv shape plus a pool is not stacked (the reference's
    jnp.stack fails on the pool's None weight); the port runs it layer by layer."""
    def net(ni):
        return ni._B("conv_pool", 8, 8, 4).conv(4, 3).pool(2).conv(4, 3).done()

    params, x, tparams, tx = _both(2, net(jax_netinfo), (2, 4, 8, 8))
    ref = jax_cnn.forward(params, net(jax_netinfo), x)
    monkeypatch.setattr(cnn, "pipeline_apply", None)  # must not be reached
    out = cnn.hybrid_forward(tparams, net(netinfo), tx, cnn.HybridPlan(2, 2),
                             pipelined=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
