"""A drift and variation source for the port's parity tests that hands
in the JAX package's own draws.

The port's drift model takes its standard-normal fields from a drift
source (``repro_torch.core.variation.DriftSource``). This one draws them
exactly as ``repro.core.variation.drift_field`` draws them from its key:
the read field from ``fold_in(fold_in(key, _READ_TAG), t)``, the cell and
column fields from ``fold_in(key, _CELL_TAG)`` and ``fold_in(key,
_COL_TAG)``; a tree node's key is ``path_fold_key(key, path)``, a
Monte-Carlo sample's ``fold_in(key, sample)``, and a ResNet layer's its
entry of ``resnet.variation_keys``. As a variation source (the port's
``core.variation.VariationSource``) it gives theta as
``jax.random.normal(key, shape)``, the field the reference's
``perturb_packed`` draws from a baked node's key, and ``split(n)`` the
sources of ``jax.random.split(key, n)``: what ``repro.api.pack_model``
hands a stacked node's layers and a bank's experts.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import variation as jvar


@partial(jax.jit, static_argnums=(1,))
def _normal(key, shape):
    return jax.random.normal(key, shape, jnp.float32)


#: drawn fields by (key bits, tag, t, shape): the persistent fields are
#: asked for again at every t and every batch
_FIELDS = {}


def _draw(key, tag, t, shape, device):
    k = (tuple(np.asarray(key).tolist()), tag, t, tuple(shape))
    if k not in _FIELDS:
        sub = jax.random.fold_in(key, tag)
        if t is not None:
            sub = jax.random.fold_in(sub, jnp.asarray(int(t), jnp.int32))
        _FIELDS[k] = np.array(_normal(sub, tuple(shape)))
    return torch.from_numpy(_FIELDS[k]).to("cpu" if device is None
                                          else device)


class JaxDriftSource:
    """``key``: a JAX PRNG key. ``layer_keys``: key -> {layer name: key}
    (``repro.models.resnet.variation_keys``) for sources indexed by layer
    name; tree paths (tuples) use ``path_fold_key``."""

    def __init__(self, key, layer_keys=None):
        self.key = key
        self.layer_keys = layer_keys
        self._by_name = None

    def at(self, sample: int) -> "JaxDriftSource":
        return JaxDriftSource(jax.random.fold_in(self.key, sample),
                              self.layer_keys)

    def for_layer(self, name) -> "JaxDriftSource":
        if isinstance(name, (tuple, list)):
            return JaxDriftSource(jvar.path_fold_key(self.key, tuple(name)),
                                  self.layer_keys)
        if self._by_name is None:
            self._by_name = self.layer_keys(self.key)
        return JaxDriftSource(self._by_name[name], self.layer_keys)

    def split(self, n):
        return [JaxDriftSource(k, self.layer_keys)
                for k in jax.random.split(self.key, int(n))]

    def theta(self, shape, device=None):
        return torch.from_numpy(np.array(_normal(self.key, tuple(shape)))).to(
            "cpu" if device is None else device)

    def read(self, shape, t, device=None):
        return _draw(self.key, jvar._READ_TAG, int(t), shape, device)

    def cell(self, shape, device=None):
        return _draw(self.key, jvar._CELL_TAG, None, shape, device)

    def col(self, shape, device=None):
        return _draw(self.key, jvar._COL_TAG, None, shape, device)
