from .http import HTTPApiServer
from .client import ApiClient, ApiError
