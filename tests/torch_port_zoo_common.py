"""Shared parts of tests/test_torch_port_zoo*.py: the parity comparison and
the check that a variables tree built from a weight table is the JAX
module's whole tree."""
import numpy as np
import torch

from emotiongestures_torch.core.layers import BatchNorm

# the parity default (test_torch_port_modules.py), of each output's largest
# entry
RTOL, ATOL = 2e-4, 2e-5


def rel_close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    """|got - want| <= atol + rtol |want|, both divided by max |want|."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               rtol=rtol, atol=atol, err_msg=msg)


def assert_tree_matches(tree, shapes, where=()):
    """`tree` (built from a table) has exactly the leaves and shapes of the
    JAX module's variables (`jax.eval_shape` of its init)."""
    assert set(tree) == set(shapes), (where, set(tree) ^ set(shapes))
    for k, v in shapes.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            assert_tree_matches(tree[k], v, where + (k,))
        else:
            assert tuple(tree[k].shape) == tuple(v.shape), where + (k,)


def perturb_bn(module, seed=0):
    """A port module's BatchNorm scale, bias and running statistics moved
    off their init values (test_torch_port_modules.py::perturb does the
    same to a JAX tree)."""
    r = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.shape
                m.weight.mul_(1 + 0.2 * torch.randn(n, generator=r))
                m.bias.add_(0.1 * torch.randn(n, generator=r))
                m.running_mean.add_(0.2 * torch.randn(n, generator=r))
                m.running_var.mul_(0.5 + torch.rand(n, generator=r))
    return module
