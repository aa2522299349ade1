"""GQA / MQA attention: the CUDA kernel (`kernel.py`, `csrc/`) of the dense
path of `models/transformer.attention`, whose plain version is
`transformer._dense_attention`."""
from .kernel import gqa_attention  # noqa: F401
