from .main import main
