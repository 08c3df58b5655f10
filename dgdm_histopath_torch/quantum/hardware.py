"""Quantum-hardware layer: an exact statevector simulator of the RY + CZ-ring
ansatz, provider backends gated on their SDKs, a manager and a hybrid
layer (counterpart of the JAX package's ``quantum/hardware.py``).

``statevector`` and ``z_expectations`` are plain torch on the caller's
device, in f32 for the layer (a 2**n-amplitude state accumulates; half
phases would bias <Z>). ``LocalStatevectorBackend`` computes the
probabilities on ``device`` (the card unless told otherwise) and samples
the counts on the host with numpy's generator, as the JAX backend does.
The IBM and Google backends report unavailable without qiskit / cirq, and
the manager then switches to the local simulator, as the reference does.
No kernel of the port runs here: the state is a few thousand amplitudes.
"""

from __future__ import annotations

import hashlib
from abc import ABC, abstractmethod
from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..nn.layers import Dense, as_dtype
from ..utils.device import resolve_device
from ..utils.logging import get_logger

logger = get_logger("quantum.hardware")

MAX_QUBITS = 12  # a 4096-amplitude statevector


class QuantumProvider(Enum):
    IBM_QUANTUM = "ibm_quantum"
    GOOGLE_QUANTUM = "google_quantum"
    SIMULATOR = "simulator"
    LOCAL_SIMULATOR = "local_simulator"


@dataclass
class QuantumConfig:
    provider: QuantumProvider = QuantumProvider.LOCAL_SIMULATOR
    backend_name: Optional[str] = None
    shots: int = 1024
    max_circuits: int = 100
    optimization_level: int = 2
    measurement_error_mitigation: bool = True
    readout_error_mitigation: bool = True
    quantum_volume_threshold: int = 32
    coherence_time_threshold: float = 50e-6
    gate_error_threshold: float = 1e-3
    seed: Optional[int] = 0


@dataclass
class Circuit:
    """The ansatz's angles [n_layers, n_qubits]: per layer an RY on each
    qubit, then a CZ ring."""

    angles: np.ndarray

    @property
    def n_layers(self) -> int:
        return int(self.angles.shape[0])

    @property
    def n_qubits(self) -> int:
        return int(self.angles.shape[1])

    def key(self) -> str:
        # the shape is hashed too: (1, 4) and (2, 2) angles share their bytes
        h = hashlib.sha1(repr(self.angles.shape).encode())
        h.update(np.ascontiguousarray(self.angles.astype(np.float64)))
        return h.hexdigest()


# ---------------------------------------------------------------------------
# the statevector
# ---------------------------------------------------------------------------

def _apply_ry(state: torch.Tensor, theta: torch.Tensor, qubit: int,
              n_qubits: int) -> torch.Tensor:
    """RY(theta) on ``qubit`` of ``state`` [..., 2**n] (little-endian)."""
    lead = state.shape[:-1]
    hi, lo = 2 ** (n_qubits - qubit - 1), 2 ** qubit
    s = state.reshape(*lead, hi, 2, lo)
    c = torch.cos(theta / 2.0)[..., None, None]
    sn = torch.sin(theta / 2.0)[..., None, None]
    a0, a1 = s[..., 0, :], s[..., 1, :]
    return torch.stack([c * a0 - sn * a1, sn * a0 + c * a1], dim=-2).reshape(
        *lead, 2 ** n_qubits)


def _cz_ring_signs(n_qubits: int) -> np.ndarray:
    """The ±1 diagonal of the CZ ring (CZ on (i, i + 1 mod n))."""
    dim = 2 ** n_qubits
    bits = (np.arange(dim)[:, None] >> np.arange(n_qubits)[None, :]) & 1
    sign = np.ones(dim, np.float32)
    if n_qubits > 1:
        pairs = ([(i, (i + 1) % n_qubits) for i in range(n_qubits)] if n_qubits > 2
                 else [(0, 1)])
        for i, j in pairs:
            sign *= np.where((bits[:, i] & bits[:, j]) == 1, -1.0, 1.0)
    return sign


def _z_signs(n_qubits: int) -> np.ndarray:
    """[n_qubits, 2**n]: the Z eigenvalue of qubit k in each basis state."""
    bits = (np.arange(2 ** n_qubits)[None, :] >> np.arange(n_qubits)[:, None]) & 1
    return (1.0 - 2.0 * bits).astype(np.float32)


def statevector(angles: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """The ansatz's final state from |0...0>: angles [..., n_layers, n_qubits]
    -> real amplitudes [..., 2**n], in angles' dtype and on its device."""
    lead = angles.shape[:-2]
    state = torch.zeros(*lead, 2 ** n_qubits, dtype=angles.dtype, device=angles.device)
    state[..., 0] = 1.0
    cz = torch.as_tensor(_cz_ring_signs(n_qubits), dtype=angles.dtype, device=angles.device)
    for layer in range(angles.shape[-2]):
        for q in range(n_qubits):
            state = _apply_ry(state, angles[..., layer, q], q, n_qubits)
        state = state * cz
    return state


def z_expectations(angles: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """Each qubit's <Z> [..., n_qubits]: the probabilities times the Z signs."""
    psi = statevector(angles, n_qubits)
    probs = psi * psi
    return probs @ torch.as_tensor(_z_signs(n_qubits), dtype=probs.dtype,
                                   device=probs.device).T


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

class QuantumBackendInterface(ABC):
    @abstractmethod
    def initialize(self, config: QuantumConfig) -> bool: ...

    @abstractmethod
    def execute_circuit(self, circuit: Circuit, shots: int = 1024) -> Dict[str, Any]: ...

    @abstractmethod
    def get_backend_properties(self) -> Dict[str, Any]: ...

    @abstractmethod
    def calibrate(self) -> Dict[str, float]: ...


class LocalStatevectorBackend(QuantumBackendInterface):
    """The exact simulator: probabilities on ``device`` (``None``: the card),
    counts drawn on the host from ``numpy.random.default_rng(config.seed)``."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self.config: Optional[QuantumConfig] = None
        self._rng = np.random.default_rng(0)

    def initialize(self, config: QuantumConfig) -> bool:
        self.config = config
        self._rng = np.random.default_rng(config.seed)
        logger.info("initialized local statevector simulator on %s", self.device)
        return True

    def probabilities(self, circuit: Circuit) -> np.ndarray:
        """|amplitude|² of each basis state, f32, computed on ``device``."""
        angles = torch.as_tensor(np.asarray(circuit.angles, np.float32), device=self.device)
        psi = statevector(angles, circuit.n_qubits)
        return (psi * psi).cpu().numpy()

    def execute_circuit(self, circuit: Circuit, shots: int = 1024) -> Dict[str, Any]:
        if circuit.n_qubits > MAX_QUBITS:
            raise ValueError(f"n_qubits {circuit.n_qubits} > {MAX_QUBITS}")
        probs = np.clip(self.probabilities(circuit), 0.0, None)
        probs /= probs.sum()
        outcomes = self._rng.choice(probs.size, size=shots, p=probs)
        counts = {format(int(o), f"0{circuit.n_qubits}b"): int(c)
                  for o, c in zip(*np.unique(outcomes, return_counts=True))}
        return {"counts": counts, "probabilities": probs,
                "metadata": {"simulation": "statevector_exact", "n_qubits": circuit.n_qubits,
                             "n_layers": circuit.n_layers, "device": str(self.device)},
                "job_id": "local_statevector"}

    def get_backend_properties(self) -> Dict[str, Any]:
        return {"name": "local_statevector", "type": "simulator", "perfect_gates": True,
                "no_decoherence": True, "max_qubits": MAX_QUBITS}

    def calibrate(self) -> Dict[str, float]:
        return {"gate_fidelity": 1.0, "measurement_fidelity": 1.0,
                "coherence_time": float("inf")}


class _UnavailableProviderBackend(QuantumBackendInterface):
    """A provider backend: unavailable unless its SDK imports."""

    sdk_module = ""
    provider_name = ""

    def __init__(self) -> None:
        self.config: Optional[QuantumConfig] = None

    def initialize(self, config: QuantumConfig) -> bool:
        try:
            __import__(self.sdk_module)
        except ImportError:
            logger.warning("%s SDK (%s) not installed; backend unavailable",
                           self.provider_name, self.sdk_module)
            return False
        self.config = config
        return True

    def execute_circuit(self, circuit: Circuit, shots: int = 1024) -> Dict[str, Any]:
        raise RuntimeError(f"{self.provider_name} backend not initialized")

    def get_backend_properties(self) -> Dict[str, Any]:
        return {"name": self.provider_name, "type": "hardware", "available": False}

    def calibrate(self) -> Dict[str, float]:
        raise RuntimeError(f"{self.provider_name} backend not initialized")


class IBMQuantumBackend(_UnavailableProviderBackend):
    sdk_module = "qiskit"
    provider_name = "ibm_quantum"


class GoogleQuantumBackend(_UnavailableProviderBackend):
    sdk_module = "cirq"
    provider_name = "google_quantum"


class QuantumHardwareManager:
    """Backend selection, circuit building and a circuit cache. The local
    simulator runs on ``device`` (``None``: the card)."""

    def __init__(self, config: Optional[QuantumConfig] = None, device=None) -> None:
        self.config = config or QuantumConfig()
        self.device = device
        self.backend: Optional[QuantumBackendInterface] = None
        self.circuit_cache: Dict[str, Dict[str, Any]] = {}
        self.calibration: Dict[str, float] = {}

    def initialize(self) -> bool:
        if self.config.provider == QuantumProvider.IBM_QUANTUM:
            self.backend = IBMQuantumBackend()
        elif self.config.provider == QuantumProvider.GOOGLE_QUANTUM:
            self.backend = GoogleQuantumBackend()
        else:
            self.backend = LocalStatevectorBackend(self.device)
        ok = self.backend.initialize(self.config)
        if not ok:
            # the provider's SDK is missing: the local simulator, as the reference does
            logger.warning("provider %s unavailable; switching to the local statevector "
                           "simulator", self.config.provider.value)
            self.backend = LocalStatevectorBackend(self.device)
            ok = self.backend.initialize(self.config)
        if ok:
            self.calibration = self.backend.calibrate()
        return ok

    @staticmethod
    def classical_to_quantum_params(features: np.ndarray, n_qubits: int,
                                    n_layers: int = 2) -> Circuit:
        """Features (tiled to n_qubits · n_layers) -> angles sigmoid(f) · 2π."""
        f = np.asarray(features, np.float64).reshape(-1)
        need = n_qubits * n_layers
        f = np.tile(f, int(np.ceil(need / max(f.size, 1))))[:need]
        angles = (1.0 / (1.0 + np.exp(-f))) * 2.0 * np.pi
        return Circuit(angles.reshape(n_layers, n_qubits).astype(np.float32))

    def optimize_circuit_for_hardware(self, circuit: Circuit) -> Circuit:
        """Angles brought into [-π, π): the same unitary, shorter pulses
        (``optimization_level`` 0 leaves the circuit as it is)."""
        if self.config.optimization_level <= 0:
            return circuit
        ang = np.mod(circuit.angles + np.pi, 2 * np.pi) - np.pi
        return Circuit(ang.astype(np.float32))

    def execute_quantum_layer(self, classical_input: np.ndarray,
                              circuit_params: Optional[Dict[str, Any]] = None) -> np.ndarray:
        """Features -> circuit -> the basis-state probabilities [2**n_qubits]
        (from the backend's probabilities, else its counts), cached by circuit."""
        if self.backend is None:
            self.initialize()
        p = circuit_params or {}
        n_qubits = int(min(p.get("n_qubits", 4), MAX_QUBITS))
        n_layers = int(p.get("n_layers", 2))
        circuit = self.optimize_circuit_for_hardware(
            self.classical_to_quantum_params(classical_input, n_qubits, n_layers))
        key = circuit.key()
        if key in self.circuit_cache:
            return self.circuit_cache[key]["features"]
        result = self.backend.execute_circuit(circuit, self.config.shots)
        if "probabilities" in result:
            feats = np.asarray(result["probabilities"], np.float32)
        else:
            total = max(sum(result["counts"].values()), 1)
            feats = np.zeros(2 ** n_qubits, np.float32)
            for bits, c in result["counts"].items():
                feats[int(bits, 2)] = c / total
        if len(self.circuit_cache) < self.config.max_circuits:
            self.circuit_cache[key] = {"features": feats}
        return feats


class HybridQuantumClassicalLayer(nn.Module):
    """input [B, input_size] -> Dense -> angles sigmoid(·) · 2π -> each
    qubit's exact <Z> (f32) -> Dense, mixed with the classical features by
    sigmoid(quantum_weight) -> Dense [B, output_size]. Differentiable end to
    end; the parameter names are the flax module's."""

    def __init__(self, input_size: int, quantum_size: int, output_size: int,
                 n_qubits: int = 6, n_layers: int = 2, dtype: str = "float32"):
        super().__init__()
        self.n_qubits = min(n_qubits, MAX_QUBITS)
        self.n_layers = n_layers
        dt = dict(dtype=as_dtype(dtype))
        self.classical_prep = Dense(input_size, quantum_size, **dt)
        self.angle_proj = Dense(quantum_size, n_layers * self.n_qubits, **dt)
        self.quantum_proj = Dense(self.n_qubits, quantum_size, **dt)
        self.classical_post = Dense(quantum_size, output_size, **dt)
        self.quantum_weight = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        classical = self.classical_prep(x)
        angles = torch.sigmoid(self.angle_proj(classical)) * (2.0 * np.pi)
        angles = angles.reshape(*x.shape[:-1], self.n_layers, self.n_qubits)
        zexp = z_expectations(angles.float(), self.n_qubits)
        quantum = self.quantum_proj(zexp)
        w = torch.sigmoid(self.quantum_weight)
        return self.classical_post(w * quantum + (1.0 - w) * classical)
