"""The model side: the arch config dataclass, layers, attention, the MoE
FFN and the dense/MoE transformer behind models/api.build."""
