from .datasets import Stage1Dataset, Stage1Sample, Stage2Dataset, Stage2Sample
