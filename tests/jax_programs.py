"""A module fixture for test files that compile JAX programs of their own:
the suite's workers run many files each, and a file's compiled programs
would otherwise stay resident for the rest of the worker's life."""

from __future__ import annotations

import ctypes
import gc

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def release_jax_programs():
    """After the module: drop JAX's compiled programs (the persistent
    compile cache keeps them on disk) and hand freed heap back."""
    yield
    jax.clear_caches()
    gc.collect()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)   # glibc
    if trim is not None:
        trim(0)
