from .profiler import Profiler
from .service import BaseService, ServiceDeadException, EOF, EOF_SENTINEL

__all__ = ["Profiler", "BaseService", "ServiceDeadException", "EOF", "EOF_SENTINEL"]
