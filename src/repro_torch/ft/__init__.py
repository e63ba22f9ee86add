from .checkpoint import (CheckpointManager, restore_latest, save_checkpoint)
from .elastic import elastic_restore, FailureSimulator
