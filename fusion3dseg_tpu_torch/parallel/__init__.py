"""The multi-device decompositions over `torch.distributed` (the JAX
package's `parallel/`): the (dp, tp) mesh and the train steps
(`sharding`), the collectives (`comm`), starting ranks (`launch`), and the
sharded voting, label lifting and fusion engines."""

from fusion3dseg_tpu_torch.parallel import (  # noqa: F401
    comm, fusion, label_fuse, launch, sharding, voting,
)
