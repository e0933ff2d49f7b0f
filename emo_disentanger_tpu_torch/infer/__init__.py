from .rules import build_rule_tables, emotion_wants_major
from .stage2_batch import Stage2BatchGenerator
