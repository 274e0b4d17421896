"""The sort system: keyspace, the batched exoshuffle, streaming rounds
and the out-of-core wave sorter, over the kernels in repro_torch.kernels."""
