from .harness import random_test, run_pipeline

__all__ = ["random_test", "run_pipeline"]
