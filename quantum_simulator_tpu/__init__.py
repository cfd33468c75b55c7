"""quantum_simulator_tpu — quantum circuit simulation framework on JAX/XLA.

A ground-up JAX/XLA rebuild of the capabilities of the reference
Quantum-Simulator (pure-NumPy statevector engine, noise channels,
measurement, analysis, debugger, optimizer, QEC, algorithms, bridge API),
re-architected for GPUs: compiled circuit programs, vmapped Monte-Carlo
trajectories, a composed group-matmul executor, and mesh-sharded
statevectors.
"""

from .circuit import GateInstance, QuantumCircuit
from .config import CONFIG, EngineConfig
from .gates import GateDefinition, GateType
from .measurement import MeasurementBasis, MeasurementEngine
from .noise import (
    AmplitudeDampingNoise,
    BitFlipNoise,
    DepolarizingNoise,
    NoiseChannel,
    NoiseModel,
    PhaseFlipNoise,
    ReadoutError,
    ThermalRelaxationNoise,
    TwoQubitDepolarizingNoise,
)
from .registry import GateRegistry
from .clifford import CliffordSimulator
from .dmrg import DMRGResult, dmrg_excited_states, dmrg_ground_state
from .mps import MPSSimulator, MPSState
from .density import DensityMatrixResult, DensityMatrixSimulator
from .lindblad import LindbladResult, LindbladSimulator
from .shadows import ShadowData, collect_shadows
from .interop import from_qasm, to_qasm
from .mitigation import (PECResult, ReadoutMitigator, ZNEResult,
                         fold_circuit, pec_expectation,
                         quasi_inverse_pauli, richardson_extrapolate,
                         zne_expectation)
from .simulator import SimulationResult, Simulator
from .state import StateVector

__version__ = "0.1.0"

__all__ = [
    "DensityMatrixResult",
    "CliffordSimulator",
    "DensityMatrixSimulator",
    "CONFIG",
    "DMRGResult",
    "dmrg_excited_states",
    "dmrg_ground_state",
    "EngineConfig",
    "GateDefinition",
    "GateInstance",
    "GateRegistry",
    "GateType",
    "MeasurementBasis",
    "MeasurementEngine",
    "LindbladResult",
    "LindbladSimulator",
    "MPSSimulator",
    "MPSState",
    "NoiseChannel",
    "NoiseModel",
    "BitFlipNoise",
    "PhaseFlipNoise",
    "DepolarizingNoise",
    "AmplitudeDampingNoise",
    "ThermalRelaxationNoise",
    "TwoQubitDepolarizingNoise",
    "ReadoutError",
    "QuantumCircuit",
    "ShadowData",
    "collect_shadows",
    "from_qasm",
    "to_qasm",
    "PECResult",
    "ReadoutMitigator",
    "ZNEResult",
    "fold_circuit",
    "pec_expectation",
    "quasi_inverse_pauli",
    "richardson_extrapolate",
    "zne_expectation",
    "SimulationResult",
    "Simulator",
    "StateVector",
]
