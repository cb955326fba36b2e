from .main import cli
