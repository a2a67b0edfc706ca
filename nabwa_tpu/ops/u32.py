"""Unsigned-32 semantics on int32 lanes.

The jnp engines keep device positions (uint32 in the reference,
bwt.h:41) as int32 bit patterns: add/sub/mul/and/or/xor/shl are
bit-identical to uint32, while compares and right shifts need the explicit
unsigned forms below.  The index arrays are stored that way on the device,
and the CUDA kernel reads the same buffers as uint32.
"""

import jax
import jax.numpy as jnp

I32 = jnp.int32
# numpy scalars, NOT jnp: a module-level jnp constant materializes a
# device array at import, initializing the backend (which hangs every
# entry point when the device link is down)
import numpy as _np

BIAS = _np.int32(-0x80000000)
NEG1 = _np.int32(-1)          # the uint32 0xFFFFFFFF


def ult(a, b):
    return (a ^ BIAS) < (b ^ BIAS)


def ule(a, b):
    return (a ^ BIAS) <= (b ^ BIAS)


def ugt(a, b):
    return (a ^ BIAS) > (b ^ BIAS)


def uge(a, b):
    return (a ^ BIAS) >= (b ^ BIAS)


def umin(a, b):
    return jnp.where(ult(a, b), a, b)


def umax(a, b):
    return jnp.where(ugt(a, b), a, b)


def ushr(a, k):
    """Logical right shift."""
    return jax.lax.shift_right_logical(a, k)
