from .pipeline import (DataConfig, MemmapBackend, SyntheticBackend,
                       TokenPipeline)
