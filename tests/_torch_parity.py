"""Helpers shared by the tests that hold the PyTorch port against the
JAX reference: one numpy array handed to both, parameters carried across
with ``from_jax_params``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.convert import from_jax_params

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def both(arr, dtype="float32"):
    return (jnp.asarray(arr).astype(JDT[dtype]),
            torch.from_numpy(np.asarray(arr)).to(TDT[dtype]))


def j2n(x):
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)
    return np.asarray(x)


def t2n(x):
    return (x.float() if x.is_floating_point() else x).numpy()


def shared_params(jax_params):
    """(reference params, port params) holding the same numbers."""
    return jax_params, from_jax_params(jax.tree.map(np.asarray, jax_params))


def rel_close(t, j, tol):
    """max |t - j| <= tol * max |j|: the tensor's scale, not each element's."""
    a, b = t2n(t), j2n(j)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-6)
    assert float(np.abs(a - b).max()) / scale <= tol, \
        (float(np.abs(a - b).max()), scale)


def fro_close(t, j, tol):
    """||t - j|| / ||j|| <= tol (relative Frobenius norm)."""
    a, b = t2n(t), j2n(j)
    assert a.shape == b.shape
    assert float(np.linalg.norm(a - b) / np.linalg.norm(b)) <= tol
