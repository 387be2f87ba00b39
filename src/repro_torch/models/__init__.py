"""PyTorch model zoo: the dense decoder family of the reference's
``models`` (layers, attention, transformer, the family-dispatching
``api``) and ``convert``, which carries the reference's weights across.

Parameters are ``nn.Module`` trees whose state-dict keys are the
reference's parameter paths, with the layer index where the reference
stacks layers on axis 0.
"""
