"""koordbalance in the port: the packed rebalance arrays so far.

:mod:`koordinator_tpu_torch.balance.pack` is the JAX package's
``RebalancePack`` copied whole (the sim's invariant checker reads its
``has_pdb_like_guard``). The device rebalance pass and its driver come
with the descheduler slice of the port. Nothing is imported here, so the
package stays light.
"""
