"""PyTorch model zoo: the dense, MoE, SSM and hybrid decoder families of
the reference's ``models`` (layers, attention, moe, ssm, transformer,
hybrid, the family-dispatching ``api``) and ``convert``, which carries
the reference's weights across. The reference's ``scan_util`` needs no
counterpart: a Python loop over an ``nn.ModuleList`` takes its place.

Parameters are ``nn.Module`` trees whose state-dict keys are the
reference's parameter paths, with the layer index where the reference
stacks layers on axis 0.
"""
