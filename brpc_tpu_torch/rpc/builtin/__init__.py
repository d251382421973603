"""Builtin admin services (reference: src/brpc/builtin/)."""
from .services import BuiltinDispatcher, register_builtin_services
