"""NeuRRAM packed CIM MVM: the CUDA kernel (`kernel.py`, `csrc/`), its
entry points (`ops.py`) and the plain-torch datapath model (`ref.py`)."""
