"""NeuRRAM packed CIM MVM: the CUDA kernel (`kernel.py`, `csrc/`), its
entry points (`ops.py`), the plain-torch datapath model (`ref.py`) and the
launch-geometry autotuner (`autotune.py`)."""
from .ref import adc_convert, cim_mvm_ref, pwl_tanh_counts  # noqa: F401
from .ops import cim_mvm, cim_mvm_packed  # noqa: F401
