"""The search levels of ``scripts/profile_refine.py``, for the port's
``bench/profile_refine.py`` tests: the script's ``level_A``, ``level_B``,
``level_D`` and ``full_B`` with its module globals (the image size, N, R
and K) taken from the inputs and arguments. Importing the script would
draw its 384x512 inputs and run its timing."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def offsets(radius, dilation):
    rng = np.arange(-radius, radius + 1) * dilation
    du, dv = np.meshgrid(rng, rng, indexing="xy")
    return np.stack([du.ravel(), dv.ravel()], -1)


@partial(jax.jit, static_argnames=("dil", "R"))
def level_A(Dimg, pq, q, dil, R=3):
    H, W, F = Dimg.shape[1:]
    N, K = H * W, (2 * R + 1) ** 2
    offs = offsets(R, dil)
    Dh = Dimg.astype(jnp.bfloat16)
    qh = q.astype(jnp.bfloat16)

    def one(Di, pqi, qi):
        rolled = jnp.stack([jnp.roll(Di, (-int(dv), -int(du)), (0, 1))
                            for du, dv in offs], 2).reshape(N, K, F)
        pu = jnp.clip(pqi[:, 0], 0, W - 1)
        pv = jnp.clip(pqi[:, 1], 0, H - 1)
        cand = rolled[pv * W + pu]
        sc = jnp.einsum("nkf,nf->nk", cand, qi,
                        preferred_element_type=jnp.float32)
        return pqi + jnp.asarray(offs)[jnp.argmax(sc, -1)]

    return jax.vmap(one)(Dh, pq, qh)


@partial(jax.jit, static_argnames=("dil", "R"))
def level_B(Dimg, pq, q, dil, R=3):
    H, W, F = Dimg.shape[1:]
    N, K = H * W, (2 * R + 1) ** 2
    offs = offsets(R, dil)
    Dh = Dimg.astype(jnp.bfloat16)
    qh = q.astype(jnp.bfloat16)

    def one(Di, pqi, qi):
        rolled = jnp.concatenate([jnp.roll(Di, (-int(dv), -int(du)), (0, 1))
                                  for du, dv in offs],
                                 axis=-1).reshape(N, K * F)
        pu = jnp.clip(pqi[:, 0], 0, W - 1)
        pv = jnp.clip(pqi[:, 1], 0, H - 1)
        cand = rolled[pv * W + pu].reshape(N, K, F)
        sc = jnp.einsum("nkf,nf->nk", cand, qi,
                        preferred_element_type=jnp.float32)
        return pqi + jnp.asarray(offs)[jnp.argmax(sc, -1)]

    return jax.vmap(one)(Dh, pq, qh)


@partial(jax.jit, static_argnames=("dil", "R"))
def level_D(Dimg, pq, q, dil, R=3):
    H, W, F = Dimg.shape[1:]
    N = H * W
    offs = offsets(R, dil)
    Dh = Dimg.astype(jnp.bfloat16)
    qh = q.astype(jnp.bfloat16)

    def one(Di, pqi, qi):
        pu = jnp.clip(pqi[:, 0], 0, W - 1)
        pv = jnp.clip(pqi[:, 1], 0, H - 1)
        lin = pv * W + pu
        scs = []
        for du, dv in offs:
            rolled = jnp.roll(Di, (-int(dv), -int(du)), (0, 1)).reshape(N, F)
            g = rolled[lin]
            scs.append(jnp.sum(g * qi, -1, dtype=jnp.float32))
        sc = jnp.stack(scs, -1)
        return pqi + jnp.asarray(offs)[jnp.argmax(sc, -1)]

    return jax.vmap(one)(Dh, pq, qh)


def full_B(Dimg, pq, q, DIL=5, R=3):
    """The script's ``full_B``, returning every level's input positions
    too (the path its near-ties are measured along)."""
    path = []
    for d in range(DIL, 0, -1):
        path.append((d, np.asarray(pq)))
        pq = level_B(Dimg, pq, q, d, R)
    return pq, path
