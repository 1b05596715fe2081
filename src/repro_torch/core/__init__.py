"""Core numerics of the port: ground costs, sampling, Sinkhorn, the legacy
entry points (deprecation shims over ``repro_torch.solve``), EMD-GW,
SaGroW, the GW alignment loss and the sharded grid solver. Exports the
names ``repro.core`` exports.

Two of those names are functions named as their modules are: ``sinkhorn``
and ``sagrow``. Here they shadow the submodules, so
``from repro_torch.core import sinkhorn`` and even
``import repro_torch.core.sinkhorn as m`` give the function. Get such a
module by its full path from ``importlib.import_module`` (or
``sys.modules``)."""
from repro_torch.core.align import gw_alignment_loss
from repro_torch.core.grid_gw import grid_cost, grid_spar_gw
from repro_torch.core.gw import (
    dense_cost,
    egw,
    fgw_dense,
    gw_dense,
    gw_objective,
    pga_gw,
)
from repro_torch.core.sagrow import sagrow
from repro_torch.core.sinkhorn import (
    sinkhorn,
    sinkhorn_log,
    sinkhorn_unbalanced,
    sparse_sinkhorn,
    sparse_sinkhorn_unbalanced,
)
from repro_torch.core.spar_gw import spar_cost, spar_fgw, spar_gw
from repro_torch.core.spar_ugw import spar_ugw, ugw_dense
