from .performer import MusicPerformer
