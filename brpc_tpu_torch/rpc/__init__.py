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
