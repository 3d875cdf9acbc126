"""Seeded synthetic video with known dense ground-truth flow.

Frames are sampled from an analytic texture T (a sum of random sinusoidal
gratings per channel, periods 6-2048 px, values 0..255), so every frame is
exact — no resampling of a stored image.  Frame t shows the texture moved
by t times a smooth non-rigid displacement field g (a translation plus a
few low-frequency modes, |g| <= ``max_disp`` px):

    frame_t(y) = T(y - t * g(y))

The forward flow of pair (t, t+1) at pixel x is f = y - x where y solves
y - (t+1) g(y) = x - t g(x); it is found by fixed-point iteration
(converges because t*|grad g| << 1 for the sizes used here).

Everything is evaluated with jax on the default device, so a 4K frame is
generated on the card in milliseconds.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

N_GRATINGS = 40
TEXTURE_STD = 30.0   # grey levels, before clipping to 0..255
N_MODES = 3


def _params(seed: int, channels: int, max_disp: float):
    rng = np.random.default_rng([seed, 0])
    # log-uniform periods, amplitude growing as sqrt(period) (a natural
    # image's falling spectrum): detail survives at every pyramid level a
    # frame is processed at, from full resolution down to 1/32 at 4K
    period = np.exp(rng.uniform(np.log(6.0), np.log(2048.0), N_GRATINGS))
    angle = rng.uniform(0.0, np.pi, N_GRATINGS)
    kx = np.cos(angle) / period
    ky = np.sin(angle) / period
    phase = rng.uniform(0.0, 2 * np.pi, (N_GRATINGS, channels))
    amp = rng.uniform(0.5, 1.5, N_GRATINGS) * np.sqrt(period / 6.0)
    amp *= TEXTURE_STD / np.sqrt((amp ** 2).sum() / 2)
    # displacement: translation + N_MODES smooth modes (in units of the
    # frame size), scaled so |g| <= max_disp everywhere
    rng = np.random.default_rng([seed, 1])
    trans = rng.uniform(-0.4, 0.4, 2)
    mk = rng.uniform(0.3, 1.5, (N_MODES, 2))
    mphase = rng.uniform(0.0, 2 * np.pi, (N_MODES, 2))
    mamp = rng.uniform(0.5, 1.0, (N_MODES, 2)) * 0.6 / N_MODES
    scale = max_disp / (np.abs(trans) + mamp.sum(0)).max()
    f32 = np.float32
    return dict(kx=kx.astype(f32), ky=ky.astype(f32), phase=phase.astype(f32),
                amp=amp.astype(f32), trans=(trans * scale).astype(f32),
                mk=mk.astype(f32), mphase=mphase.astype(f32),
                mamp=(mamp * scale).astype(f32))


def _texture(x, y, prm):
    """T at float coordinates x, y [...] -> [..., C]."""
    out = 128.0
    for k in range(N_GRATINGS):
        arg = 2 * jnp.pi * (prm["kx"][k] * x + prm["ky"][k] * y)
        out = out + prm["amp"][k] * jnp.sin(arg[..., None]
                                            + prm["phase"][k])
    return jnp.clip(out, 0.0, 255.0)


def _disp(x, y, h, w, prm):
    """g at float coordinates -> (gx, gy)."""
    u = x / w
    v = y / h
    g = []
    for c in range(2):
        acc = prm["trans"][c]
        for m in range(N_MODES):
            acc = acc + prm["mamp"][m, c] * jnp.sin(
                2 * jnp.pi * (prm["mk"][m, 0] * u + prm["mk"][m, 1] * v)
                + prm["mphase"][m, c])
        g.append(acc)
    return g[0], g[1]


@functools.partial(jax.jit, static_argnames=("h", "w", "channels",
                                             "max_disp", "seed"))
def _frame(t, *, h, w, channels, max_disp, seed):
    prm = jax.tree.map(jnp.asarray, _params(seed, channels, max_disp))
    y, x = jnp.mgrid[0:h, 0:w].astype(jnp.float32)
    gx, gy = _disp(x, y, h, w, prm)
    return _texture(x - t * gx, y - t * gy, prm)


@functools.partial(jax.jit, static_argnames=("h", "w", "max_disp", "seed",
                                             "iters"))
def _flow(t, *, h, w, max_disp, seed, iters=40):
    prm = jax.tree.map(jnp.asarray, _params(seed, 1, max_disp))
    y, x = jnp.mgrid[0:h, 0:w].astype(jnp.float32)
    gx, gy = _disp(x, y, h, w, prm)
    ux, uy = x - t * gx, y - t * gy          # texture coords of pixel x

    def body(_, yx):
        yy, xx = yx
        hx, hy = _disp(xx, yy, h, w, prm)
        return uy + (t + 1) * hy, ux + (t + 1) * hx

    yy, xx = jax.lax.fori_loop(0, iters, body, (y + gy, x + gx))
    return jnp.stack([xx - x, yy - y], axis=-1)


def frame(t: int, h: int, w: int, seed: int = 0, channels: int = 3,
          max_disp: float = 5.0) -> jax.Array:
    """Frame ``t`` [h, w, channels] float32 (0..255) on the default
    device."""
    return _frame(jnp.float32(t), h=h, w=w, channels=channels,
                  max_disp=float(max_disp), seed=seed)


def flow(t: int, h: int, w: int, seed: int = 0,
         max_disp: float = 5.0) -> jax.Array:
    """Ground-truth forward flow [h, w, 2] (u, v) of pair (t, t+1)."""
    return _flow(jnp.float32(t), h=h, w=w, max_disp=float(max_disp),
                 seed=seed)


def pair(h: int, w: int, seed: int = 0, channels: int = 3,
         max_disp: float = 5.0):
    """(I0, I1, flow_gt) for pair (0, 1) as numpy arrays."""
    return (np.asarray(frame(0, h, w, seed, channels, max_disp)),
            np.asarray(frame(1, h, w, seed, channels, max_disp)),
            np.asarray(flow(0, h, w, seed, max_disp)))
