"""AdamW with fp32 master weights, the cosine LR schedule and int8 gradient
compression with error feedback (port of ``repro/optim``), over the port's
flat parameter dicts."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, global_norm  # noqa: F401
from repro_torch.optim.grad_compress import compress_decompress, error_feedback_update  # noqa: F401
from repro_torch.optim.schedules import cosine_schedule  # noqa: F401
