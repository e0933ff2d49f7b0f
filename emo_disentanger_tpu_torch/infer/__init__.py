from .reference_exact import (
    generate_stage1_reference_exact, generate_stage2_reference_exact)
from .rules import build_rule_tables, emotion_wants_major
from .stage1 import Stage1Generator
from .stage1_batch import Stage1BatchGenerator
from .stage2 import Stage2Generator
from .stage2_batch import Stage2BatchGenerator
