"""PianoPIR protocol stack: single-partition core, batch schedulers, and
device/sharded engines."""

from pacmann.pir.params import derive_batch_params, derive_piano_params  # noqa: F401
from pacmann.pir.piano import PianoPIR  # noqa: F401
from pacmann.pir.batch import SimpleBatchPianoPIR  # noqa: F401
from pacmann.pir.engine import FusedBatchPianoPIR  # noqa: F401
from pacmann.pir.device_engine import DevicePianoEngine  # noqa: F401
