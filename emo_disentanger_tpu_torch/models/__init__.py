from .gpt2 import MusicGPT2
from .performer import MusicPerformer
from .txl import PlainTransformer
