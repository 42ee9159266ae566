"""Helpers of the demo parity tests (tests/test_torch_examples*.py): the
JAX trainer's push seeds a pass, and its creation draws replaced by the
port's hash."""

import jax
import jax.numpy as jnp


def pass_seeds(n_passes, n_steps, seed=0):
    """The push seeds of the JAX trainer's passes, in order: the table's
    next_prng a pass, one split a step, the randint the push takes
    (tests/test_torch_train.py)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_passes):
        key, prng = jax.random.split(key)
        for _ in range(n_steps):
            prng, sub = jax.random.split(prng)
            out.append(int(jax.random.randint(sub, (), 0,
                                              jnp.int32(2**31 - 1))))
    return out


def hash_fresh(d):
    """The reference's _fresh_uniform as the port creates columns (the
    Pallas kernel's hash; expand column e hashes d + e)."""

    def fresh(prng, row_ids, shape, dtype, maxval, stream=0):
        seed = jax.random.randint(prng, (), 0, jnp.int32(2**31 - 1))
        r = jnp.asarray(row_ids).astype(jnp.uint32)[:, None]
        c = (jnp.arange(shape[1], dtype=jnp.uint32)[None, :]
             + jnp.uint32(d if stream else 0))
        bits = (r * jnp.uint32(2654435761)) ^ (c * jnp.uint32(40503)
                                               + seed.astype(jnp.uint32))
        bits = bits * jnp.uint32(747796405) + jnp.uint32(2891336453)
        bits ^= bits >> 16
        u01 = ((bits >> 8).astype(jnp.int32).astype(jnp.float32)
               * (1.0 / (1 << 24)))
        return (u01 * maxval).astype(dtype)

    return fresh
