"""The device mesh: the port's counterpart of the JAX package's sharding layer.

The reference's only parallelism is shared-memory chunking via rayon
(`halo2_proofs/src/multicore.rs`, `arithmetic.rs:310-327`). The JAX package
shards the three hot axes over a `jax.sharding.Mesh`; the port keeps its
single-process design over an ordered list of torch devices
(`context.Mesh`), where an exchange between shards is a tensor copy:

  * **NTT** - four-step decomposition with the transposes as chunk
    exchanges between the shards (`ntt.py`).
  * **MSM** - points sharded per device; each device runs the bucket MSM
    on its slab, and the partial window sums are added up by a log2(D)-round
    butterfly of complete additions (`msm.py`).
  * **evaluate_h** - the extended domain cut into row blocks, rotations
    exchanging the rows at block edges (`quotient.py`, and
    `plonk/evaluation.py` `evaluate_h_mesh`).

Counterpart of `halo2_tpu/parallel/__init__.py`, with the same exports.
"""

from .context import MeshContext, active_mesh, use_mesh
from .ntt import FourStepNtt, make_mesh
from .msm import sharded_msm
from .quotient import ShardedQuotient

__all__ = [
    "FourStepNtt",
    "MeshContext",
    "ShardedQuotient",
    "active_mesh",
    "make_mesh",
    "sharded_msm",
    "use_mesh",
]
