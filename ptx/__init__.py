"""ptx — a differentiable CSG path tracer in JAX.

A from-scratch JAX/XLA re-conception of the classic CSG span-tracing
renderer (reference: programmerjake/path-trace, C++/pthreads/TCP).  The
reference's architecture — virtual-dispatch span iterators, per-ray recursion,
a pthread block pool, and an ASCII TCP render farm — is replaced by an
array-first design:

- scenes compile to SoA parameter tables + a flattened CSG tape
  (:mod:`ptx.geom.tape`),
- primitive intersection and the union/intersection/difference span algebra
  are vectorized sorted-interval passes over fixed-capacity masked span
  lists (:mod:`ptx.geom.spans`),
- the recursive shading loop becomes a masked fixed-depth ``lax.scan``
  wavefront with one stochastic path per ray (:mod:`ptx.integrate.trace`),
- pixels/samples shard over a ``jax.sharding.Mesh`` with psum aggregation
  (:mod:`ptx.parallel`),
- the host-side runtime (tile scheduler, TCP render farm, fast RGBE codec)
  is native C++ (:mod:`ptx.runtime`).

Everything that touches rays is differentiable: pixel gradients w.r.t.
material, transform, and texture parameters flow through the bounce scan.
"""

__version__ = "0.1.0"

from ptx.core import constants  # noqa: F401
