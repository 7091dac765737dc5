"""Seeded lint fixture (never imported): a port module that imports the
reference. Four I001."""
import jax
import jax.numpy as jnp
from repro.core import sodm
from repro import observe

import repro_torch  # the port itself is fine
