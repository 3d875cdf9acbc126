"""Halo exchange for row-sharded images inside ``shard_map``.

The stencil stages (pyramid gradients, 5-tap derivatives, SOR sweeps,
densification borders) need a few rows from the neighboring shard.
These are nearest-neighbor ``lax.ppermute`` transfers (NVLink between
GPUs of one host) — the collective analogue of the reference's shared-memory adjacency
(SURVEY.md §2.4, §5 'long-context analogue').

Convention: the image is split along axis 0 (rows) across the mesh axis
``axis_name``; shard i holds rows [i*h_local, (i+1)*h_local).  Boundary
shards replicate their own edge rows (matching the replicate-border
semantics of the unsharded ops) or zero-fill, per ``mode``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def exchange_rows(x: jax.Array, halo: int, axis_name: str,
                  mode: str = "edge") -> jax.Array:
    """Return x extended with ``halo`` rows from each neighbor:
    [h + 2*halo, ...].

    mode='edge': outermost shards replicate their own border rows (for
    replicate-border convolutions); mode='zero': zero fill (for gradient
    zero-padding / accumulator margins).
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)

    if n == 1:
        if mode == "edge":
            top = jnp.repeat(x[:1], halo, axis=0)
            bot = jnp.repeat(x[-1:], halo, axis=0)
        else:
            top = jnp.zeros((halo,) + x.shape[1:], x.dtype)
            bot = jnp.zeros((halo,) + x.shape[1:], x.dtype)
        return jnp.concatenate([top, x, bot], axis=0)

    # rows my bottom -> next shard's top halo; my top -> previous's bottom
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    from_prev = lax.ppermute(x[-halo:], axis_name, fwd)   # prev shard's last rows
    from_next = lax.ppermute(x[:halo], axis_name, bwd)    # next shard's first rows

    if mode == "edge":
        edge_top = jnp.repeat(x[:1], halo, axis=0)
        edge_bot = jnp.repeat(x[-1:], halo, axis=0)
    else:
        edge_top = jnp.zeros_like(from_prev)
        edge_bot = jnp.zeros_like(from_next)

    top = jnp.where(idx == 0, edge_top, from_prev)
    bot = jnp.where(idx == n - 1, edge_bot, from_next)
    return jnp.concatenate([top, x, bot], axis=0)


def exchange_accumulate_rows(x: jax.Array, halo: int, axis_name: str) -> jax.Array:
    """Fold overflowed accumulator margins into the neighbors' interiors.

    Inverse of :func:`exchange_rows` for scatter-style ops: ``x`` is a
    local accumulator with ``halo`` extra rows on each side holding
    contributions that belong to the neighboring shard.  Those margins are
    shipped via ppermute and summed into the neighbor's edge rows;
    contributions beyond the global image (outermost shards) are dropped.
    Returns the [h_local, ...] interior with halo contributions added.
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    top_margin = x[:halo]
    bot_margin = x[-halo:]
    interior = x[halo:-halo]

    if n == 1:
        return interior

    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    # my bottom margin are rows belonging to the next shard's top interior
    from_prev = lax.ppermute(bot_margin, axis_name, fwd)
    from_next = lax.ppermute(top_margin, axis_name, bwd)
    from_prev = jnp.where(idx == 0, jnp.zeros_like(from_prev), from_prev)
    from_next = jnp.where(idx == n - 1, jnp.zeros_like(from_next), from_next)

    interior = interior.at[:halo].add(from_prev)
    interior = interior.at[-halo:].add(from_next)
    return interior


def exchange_cols(x: jax.Array, halo: int, axis_name: str,
                  mode: str = "edge") -> jax.Array:
    """Column analogue of :func:`exchange_rows`: the image is split along
    axis 1 across ``axis_name``; returns x extended with ``halo`` columns
    from each lateral neighbor: [..., w + 2*halo, ...].

    Applied after :func:`exchange_rows` on a row-extended array this also
    fills the corner blocks correctly: the lateral neighbor's shipped
    columns already carry *its* row halo, which came from our diagonal
    neighbor (the standard sequential-exchange corner trick) — one 2D
    halo costs two ppermutes, not eight.
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)

    if n == 1:
        if mode == "edge":
            left = jnp.repeat(x[:, :1], halo, axis=1)
            right = jnp.repeat(x[:, -1:], halo, axis=1)
        else:
            left = jnp.zeros(x.shape[:1] + (halo,) + x.shape[2:], x.dtype)
            right = jnp.zeros(x.shape[:1] + (halo,) + x.shape[2:], x.dtype)
        return jnp.concatenate([left, x, right], axis=1)

    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    from_prev = lax.ppermute(x[:, -halo:], axis_name, fwd)
    from_next = lax.ppermute(x[:, :halo], axis_name, bwd)

    if mode == "edge":
        edge_l = jnp.repeat(x[:, :1], halo, axis=1)
        edge_r = jnp.repeat(x[:, -1:], halo, axis=1)
    else:
        edge_l = jnp.zeros_like(from_prev)
        edge_r = jnp.zeros_like(from_next)

    left = jnp.where(idx == 0, edge_l, from_prev)
    right = jnp.where(idx == n - 1, edge_r, from_next)
    return jnp.concatenate([left, x, right], axis=1)


def exchange_accumulate_cols(x: jax.Array, halo: int, axis_name: str) -> jax.Array:
    """Column analogue of :func:`exchange_accumulate_rows`: fold the
    ``halo`` overflow columns on each side into the lateral neighbors'
    interiors; returns the [..., w_local, ...] interior."""
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    left_margin = x[:, :halo]
    right_margin = x[:, -halo:]
    interior = x[:, halo:-halo]

    if n == 1:
        return interior

    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    from_prev = lax.ppermute(right_margin, axis_name, fwd)
    from_next = lax.ppermute(left_margin, axis_name, bwd)
    from_prev = jnp.where(idx == 0, jnp.zeros_like(from_prev), from_prev)
    from_next = jnp.where(idx == n - 1, jnp.zeros_like(from_next), from_next)

    interior = interior.at[:, :halo].add(from_prev)
    interior = interior.at[:, -halo:].add(from_next)
    return interior
