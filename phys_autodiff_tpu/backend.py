"""The one platform dispatch.

Every accelerated path of the package is plain JAX (which XLA compiles for
whatever backend runs it) except the Pallas kernels, which are written for
the Triton route (`pl.pallas_call(..., backend="triton")`). Those compile
for an NVIDIA GPU and run in Pallas' interpreter on the CPU, which is how
the test suite checks them. Any other platform has no route and is an
error, never a silent fallback.
"""

from __future__ import annotations

import jax

# platform -> run Pallas kernels in interpret mode?
_PALLAS_INTERPRET = {"gpu": False, "cpu": True}


def pallas_interpret(platform: str | None = None) -> bool:
    """Whether Pallas kernels run interpreted on `platform` (default: JAX's
    default backend). Raises for a platform with no kernel route."""
    platform = jax.default_backend() if platform is None else platform
    try:
        return _PALLAS_INTERPRET[platform]
    except KeyError:
        raise RuntimeError(
            f"no kernel route for platform {platform!r}: "
            f"expected one of {sorted(_PALLAS_INTERPRET)}"
        ) from None
