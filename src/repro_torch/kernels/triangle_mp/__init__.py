from repro_torch.kernels.triangle_mp.ops import mp_sweep
from repro_torch.kernels.triangle_mp.ref import mp_sweep_ref

__all__ = ["mp_sweep", "mp_sweep_ref"]
