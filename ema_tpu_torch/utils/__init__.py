from ema_tpu_torch.utils.barcodes import (  # noqa: F401
    encode_bc,
    decode_bc,
    encode_bc_batch,
    decode_bc_batch,
    extract_bc_from_id,
)
from ema_tpu_torch.utils.logprobs import normalize_log_probs, normalize_log_probs_batch  # noqa: F401
