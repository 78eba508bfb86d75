"""Brain-simulation substrate of the port: model generator, neuron
dynamics, single-device reference engine, the communicators (loopback, and
one rank per process over ``torch.distributed``) and the distributed engine
whose spike exchange follows the paper's routing."""
from repro_torch.snn.model import BrainModel, generate_brain_model
from repro_torch.snn.neuron import (
    IzhikevichParams,
    LIFParams,
    NeuronState,
    init_state,
    izhikevich_step,
    lif_step,
)
from repro_torch.snn.engine import (
    RunResult,
    SNNEngine,
    expand_synapses,
    expand_synapses_sparse,
)
from repro_torch.snn.sparse import (
    BlockSynapses,
    exchange_messages,
    exchange_schedule,
    exchange_volume,
)
from repro_torch.snn.ragged import (
    RaggedPlan,
    RaggedRound,
    bridge_inner_from_table,
    build_ragged_plan,
    build_ragged_plan_from_mask,
)
from repro_torch.snn.comm import LoopbackComm, ProcessGroupComm
from repro_torch.snn.distributed import (
    DistributedSNN,
    PlanBuffer,
    gather_raster,
    group_mesh_permutation,
    partition_permutation,
    permute_ranks,
)

__all__ = [
    "BrainModel",
    "generate_brain_model",
    "LIFParams",
    "IzhikevichParams",
    "NeuronState",
    "init_state",
    "lif_step",
    "izhikevich_step",
    "SNNEngine",
    "RunResult",
    "expand_synapses",
    "expand_synapses_sparse",
    "BlockSynapses",
    "exchange_messages",
    "exchange_schedule",
    "exchange_volume",
    "RaggedPlan",
    "RaggedRound",
    "bridge_inner_from_table",
    "build_ragged_plan",
    "build_ragged_plan_from_mask",
    "LoopbackComm",
    "ProcessGroupComm",
    "DistributedSNN",
    "PlanBuffer",
    "gather_raster",
    "group_mesh_permutation",
    "permute_ranks",
    "partition_permutation",
]
