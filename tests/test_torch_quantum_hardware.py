"""The port's statevector simulator and hybrid layer (``quantum/hardware.py``)
against the JAX package's, on the CPU.

The statevector is f32 in both: amplitudes and <Z> agree within 1e-6. The
counts are drawn from the probabilities by numpy's generator in both, so
given the same probabilities they are equal (from each package's own f32
probabilities a rounding step can move one of thousands of samples). The
hybrid layer takes the flax layer's parameters through ``convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgdm_histopath_tpu.quantum import hardware as jhw
from dgdm_histopath_torch.convert import load_state, params_from_flax
from dgdm_histopath_torch.quantum import hardware as thw


def _angles(shape, seed):
    return np.random.default_rng(seed).uniform(0, 2 * np.pi, shape).astype(np.float32)


@pytest.mark.parametrize("n_qubits,lead", [(1, ()), (2, (3,)), (4, (2, 5)), (6, ())])
def test_statevector_and_z_expectations_equal_jax(n_qubits, lead):
    a = _angles(lead + (3, n_qubits), n_qubits)
    with jax.default_matmul_precision("float32"):
        jpsi, jz = jax.jit(lambda t: (jhw.statevector(t, n_qubits),
                                      jhw.z_expectations(t, n_qubits)))(jnp.asarray(a))
    psi = thw.statevector(torch.from_numpy(a), n_qubits).numpy()
    np.testing.assert_allclose(psi, np.asarray(jpsi), rtol=0, atol=1e-6)
    z = thw.z_expectations(torch.from_numpy(a), n_qubits).numpy()
    np.testing.assert_allclose(z, np.asarray(jz), rtol=0, atol=1e-6)
    assert z.shape == lead + (n_qubits,)
    np.testing.assert_allclose((psi ** 2).sum(-1), 1.0, atol=1e-6)


def test_two_qubit_golden_against_dense_matrices():
    theta = np.array([[0.7, 1.9]])

    def ry(t):
        c, s = np.cos(t / 2), np.sin(t / 2)
        return np.array([[c, -s], [s, c]])
    expected = (np.diag([1.0, 1.0, 1.0, -1.0]) @ np.kron(ry(theta[0, 1]), np.eye(2))
                @ np.kron(np.eye(2), ry(theta[0, 0])) @ np.array([1.0, 0, 0, 0]))
    psi = thw.statevector(torch.tensor(theta, dtype=torch.float32), 2).numpy()
    np.testing.assert_allclose(psi, expected, atol=1e-6)


def test_backend_probabilities_and_counts_equal_jax():
    circ = thw.Circuit(_angles((2, 5), 3))
    port = thw.LocalStatevectorBackend(device="cpu")
    ref = jhw.LocalStatevectorBackend()
    cfg = dict(shots=3000, seed=4)
    assert port.initialize(thw.QuantumConfig(**cfg)) and ref.initialize(jhw.QuantumConfig(**cfg))
    jres = ref.execute_circuit(jhw.Circuit(circ.angles), shots=3000)
    np.testing.assert_allclose(port.probabilities(circ), jres["probabilities"], rtol=0,
                               atol=1e-6)
    # counts from the same probabilities are the same draws
    ref.initialize(jhw.QuantumConfig(**cfg))
    jres = ref.execute_circuit(jhw.Circuit(circ.angles), shots=3000)
    port.probabilities = lambda c: jres["probabilities"].copy()
    res = port.execute_circuit(circ, shots=3000)
    assert res["counts"] == jres["counts"] and sum(res["counts"].values()) == 3000
    assert res["metadata"]["device"] == "cpu"
    with pytest.raises(ValueError, match="n_qubits"):
        port.execute_circuit(thw.Circuit(np.zeros((1, 13), np.float32)))


@pytest.mark.parametrize("provider", ["ibm_quantum", "google_quantum", "local_simulator"])
def test_manager_switches_to_the_local_simulator(provider):
    mgr = thw.QuantumHardwareManager(
        thw.QuantumConfig(provider=thw.QuantumProvider(provider), shots=256, seed=3),
        device="cpu")
    assert mgr.initialize() and isinstance(mgr.backend, thw.LocalStatevectorBackend)
    assert mgr.calibration == jhw.LocalStatevectorBackend().calibrate()
    x = np.linspace(-1, 1, 8, dtype=np.float32)
    feats = mgr.execute_quantum_layer(x, {"n_qubits": 3, "n_layers": 2})
    jm = jhw.QuantumHardwareManager(jhw.QuantumConfig(shots=256, seed=3))
    jm.initialize()
    np.testing.assert_allclose(feats, jm.execute_quantum_layer(x, {"n_qubits": 3,
                                                                   "n_layers": 2}),
                               rtol=0, atol=1e-6)
    assert mgr.execute_quantum_layer(x, {"n_qubits": 3, "n_layers": 2}) is feats  # cached
    assert thw.IBMQuantumBackend().get_backend_properties()["available"] is False


def test_circuit_optimization_and_key_equal_jax():
    angles = np.asarray([[5.0, 0.1, 6.2], [-4.0, 3.3, 1.0]], np.float32)
    port = thw.QuantumHardwareManager(thw.QuantumConfig(optimization_level=2), device="cpu")
    opt = port.optimize_circuit_for_hardware(thw.Circuit(angles))
    ref = jhw.QuantumHardwareManager(jhw.QuantumConfig(optimization_level=2))
    np.testing.assert_array_equal(opt.angles,
                                  ref.optimize_circuit_for_hardware(jhw.Circuit(angles)).angles)
    probs = [(thw.statevector(torch.from_numpy(c), 3) ** 2).numpy() for c in (angles,
                                                                              opt.angles)]
    np.testing.assert_allclose(probs[0], probs[1], atol=1e-5)     # the same unitary up to sign
    assert thw.Circuit(angles).key() == jhw.Circuit(angles).key()
    assert thw.Circuit(angles.reshape(3, 2)).key() != thw.Circuit(angles).key()
    np.testing.assert_array_equal(
        thw.QuantumHardwareManager.classical_to_quantum_params(np.arange(5.0), 4, 3).angles,
        jhw.QuantumHardwareManager.classical_to_quantum_params(np.arange(5.0), 4, 3).angles)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


@pytest.mark.parametrize("n_qubits,n_layers", [(4, 2), (6, 3)])
def test_hybrid_layer_equals_jax(n_qubits, n_layers):
    """Outputs within 1e-5 and input gradients within 1e-4 of the flax layer
    with its parameters carried across (``quantum_weight`` set away from 0)."""
    jl = jhw.HybridQuantumClassicalLayer(input_size=16, quantum_size=8, output_size=3,
                                         n_qubits=n_qubits, n_layers=n_layers)
    x = np.random.default_rng(0).normal(size=(5, 16)).astype(np.float32)
    params = jax.device_get(jax.jit(jl.init)(jax.random.PRNGKey(n_qubits), jnp.asarray(x)))
    params["params"]["quantum_weight"] = np.float32(0.3)
    layer = thw.HybridQuantumClassicalLayer(16, 8, 3, n_qubits=n_qubits, n_layers=n_layers)
    load_state(layer, params_from_flax(_flat(params)))
    assert layer.quantum_weight.shape == () and float(layer.quantum_weight.detach()) == \
        pytest.approx(0.3)

    def fwd_and_grad(xx):
        out, vjp = jax.vjp(lambda v: jl.apply(params, v), xx)
        return out, vjp(2.0 * out)[0]
    with jax.default_matmul_precision("float32"):
        out, jgrad = jax.jit(fwd_and_grad)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer(xt)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-4)
    assert layer.angle_proj.weight.grad.abs().max() > 0     # the quantum path trains
