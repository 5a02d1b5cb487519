"""Scale-out of the port: one process per GPU (parallel/distributed.py)
running the pipelines on its slice of the catalog, with the calibration
sums all-reduced across the processes (parallel/mesh.py)."""
from . import distributed  # noqa: F401
from .mesh import (  # noqa: F401
    make_sharded_mb_pipeline_fn,
    make_sharded_pipeline_fn,
    sharded_shear_response,
)
