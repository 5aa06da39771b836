"""The in-repo pytree dataclass helper and the compile-cache location."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pop2_tpu import compile_cache, pytree
from pop2_tpu.forcing_tools import MonthlyClimatology


@pytree.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray
    tag: str = pytree.static_field(default="x")


def test_replace_returns_updated_copy():
    p = _Pair(a=jnp.zeros(2), b=jnp.ones(3))
    q = p.replace(b=jnp.full(3, 2.0), tag="y")
    assert q is not p and q.tag == "y" and p.tag == "x"
    np.testing.assert_array_equal(np.asarray(q.a), np.zeros(2))
    np.testing.assert_array_equal(np.asarray(q.b), np.full(3, 2.0))
    with pytest.raises(AttributeError):
        p.a = jnp.ones(2)           # frozen


def test_flatten_round_trip_keeps_static_field_out_of_leaves():
    p = _Pair(a=jnp.arange(2.0), b=jnp.arange(3.0), tag="kept")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2
    assert not any(isinstance(x, str) for x in leaves)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.tag == "kept"
    np.testing.assert_array_equal(np.asarray(back.b), np.arange(3.0))
    # the static field is part of the treedef: a different tag differs
    other = jax.tree_util.tree_structure(p.replace(tag="other"))
    assert other != treedef


def test_static_field_in_package_dataclass():
    clim = MonthlyClimatology.create(jnp.ones((12, 2, 3)), interp="nearest")
    leaves = jax.tree_util.tree_leaves(clim)
    assert len(leaves) == 2 and clim.interp == "nearest"
    doubled = jax.tree_util.tree_map(lambda x: 2 * x, clim)
    assert doubled.interp == "nearest"


def test_jit_through_grid(mini_grid):
    @jax.jit
    def ocean_area(g):
        return jnp.sum(jnp.where(g.KMT > 0, g.TAREA, 0.0)), g.replace(
            HT=g.HT + 1.0)

    area, g2 = ocean_area(mini_grid)
    want = np.where(np.asarray(mini_grid.KMT) > 0,
                    np.asarray(mini_grid.TAREA), 0.0).sum()
    np.testing.assert_allclose(float(area), want, rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(g2.HT),
                                  np.asarray(mini_grid.HT) + 1.0)
    assert type(g2) is type(mini_grid)


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.enable() == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        repo, ".jax_cache")


def test_compile_cache_follows_env_var(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # untouched
