"""Pattern mining over the CUDA trace: iteration detection (``aisi``),
host-sample swarms (``hsg``) and the run-to-run ``diff`` (the JAX
package's ``sofa_tpu/ml/``), on the suffix automaton of ``suffix``."""
