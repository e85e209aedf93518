from .checkpoint import (elastic_rescale_ef, latest_step,  # noqa: F401
                         restore_checkpoint, save_checkpoint)
