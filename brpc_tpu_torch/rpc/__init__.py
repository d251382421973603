"""rpc — core runtime (reference: src/brpc/)."""
from . import errors
from .errors import RpcError, berror
from .protocol import (Protocol, ParseResult, ParseResultType,
                       register_protocol, find_protocol, list_protocols)
from .socket import Socket, SocketStat, WriteRequest, list_sockets
from .input_messenger import InputMessenger
from .controller import Controller
from .service import Service, method, MethodDescriptor
from .server import Server, ServerOptions
from .channel import Channel, ChannelOptions
from .socket_map import SocketMap
from .admission import AdmissionController, AdmissionOptions
from .method_status import MethodStatus
from . import compress
from . import span
from .stream import (Stream, StreamOptions, StreamInputHandler, stream_create,
                     stream_accept, find_stream, live_streams)
from .circuit_breaker import (CircuitBreaker, ClusterRecoverPolicy,
                              BreakerRegistry)
from .health_check import start_health_check, probe_endpoint, HealthCheckTask
from .progressive import (ProgressiveReader, ProgressiveAttachment,
                          response_will_be_read_progressively,
                          create_progressive_attachment)
from . import profiler
from . import rpc_dump
