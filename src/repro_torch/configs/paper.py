"""The paper's own workload (port of ``repro.configs.paper``): dense
square matmuls of 2^n elements per side, n in {10, 11, 12}, under
row-major / Morton / Hilbert orderings.  Imported directly, as in the
reference; it is not an architecture of the ``ARCHS`` registry.  The
reference's CPU settings (DVFS frequencies, thread counts) mean nothing
on the card and are not kept; ``chip_smoke.py``'s locality study reads
every field here."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperConfig:
    sizes: tuple = (10, 11, 12)           # log2 matrix dim
    schedules: tuple = ("rowmajor", "morton", "hilbert")
    dtype: str = "float32"                # the paper's doubles, in f32
    block: int = 128                      # tile granularity


CONFIG = PaperConfig()
