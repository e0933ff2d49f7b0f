from .reference_exact import generate_stage2_reference_exact
from .rules import build_rule_tables, emotion_wants_major
from .stage2 import Stage2Generator
from .stage2_batch import Stage2BatchGenerator
