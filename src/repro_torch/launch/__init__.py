"""Entry points of the port's LM stack, the production mesh and the dry
run (`launch.dryrun`)."""
from repro_torch.launch.mesh import (make_host_mesh, make_layout_mesh,
                                     make_production_mesh)
