from .datasets import Stage2Dataset, Stage2Sample
