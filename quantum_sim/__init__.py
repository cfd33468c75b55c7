"""quantum_sim — drop-in compatibility facade over quantum_simulator_tpu.

Existing code written against the reference package layout
(``quantum_sim.engine.*`` / ``quantum_sim.core.*``; see
``/root/reference/quantum_sim``) imports unchanged and runs on the
accelerator-native engine. Each submodule re-exports the corresponding
``quantum_simulator_tpu`` module.
"""
