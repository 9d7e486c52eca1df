from jstsp19.parallel.distributed import (  # noqa: F401
    distributed_run_point,
    distributed_run_sweep,
    global_mc_mesh,
    initialize_from_env,
)
from jstsp19.parallel.mesh import make_mesh, mesh_shape_for  # noqa: F401
from jstsp19.parallel.ring import (  # noqa: F401
    mc_mean_ring,
    ring_allreduce_mean,
    ring_pipeline_map,
)
from jstsp19.parallel.sharded_admm import sharded_admm_step  # noqa: F401
