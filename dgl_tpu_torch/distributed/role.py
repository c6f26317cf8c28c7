"""Role and context registry and host networking utilities (counterpart
of ``dgl_tpu/distributed/role.py``; reference
``python/dgl/distributed/role.py``, ``rpc.py`` get_local_usable_addr,
``dist_context.py`` init/get_kvstore).

Every process is server and trainer of its part at once; the registry
tracks the process-local KVServer/KVClient pair and the role label. Ranks
are ``torch.distributed``'s (``dist_context``).
"""
from __future__ import annotations

import socket
from typing import Optional

__all__ = [
    "init_role",
    "get_role",
    "init_kvstore",
    "get_kvstore",
    "close_kvstore",
    "get_trainer_rank",
    "get_num_trainers",
    "get_global_rank",
    "read_ip_config",
    "get_local_usable_addr",
    "local_ip4_addr_list",
    "alltoall",
    "alltoall_cpu",
    "alltoallv",
    "alltoallv_cpu",
]

_ROLE = "default"
_KVCLIENT = None


def init_role(role: str):
    """(reference ``role.py`` init_role)."""
    global _ROLE
    _ROLE = role


def get_role() -> str:
    return _ROLE


def init_kvstore(ip_config=None, num_servers: int = 1,
                 role: str = "default"):
    """Create the process-local KV pair (reference ``dist_context.py``
    initialize's kvstore branch)."""
    global _KVCLIENT
    from .kvstore import KVClient, KVServer

    init_role(role)
    server = KVServer(server_id=0, num_clients=1, ip_config=ip_config)
    _KVCLIENT = KVClient(server, role=role)
    return _KVCLIENT


def get_kvstore():
    """(reference ``dist_context.py`` get_kvstore)."""
    return _KVCLIENT


def close_kvstore():
    global _KVCLIENT
    _KVCLIENT = None


def get_trainer_rank() -> int:
    from .dist_context import get_rank

    return get_rank()


def get_num_trainers() -> int:
    from .dist_context import get_world_size

    return get_world_size()


def get_global_rank() -> int:
    return get_trainer_rank()


def read_ip_config(filename: str):
    """Parse the reference's ip_config format: one 'ip [port]' per line ->
    {machine_id: (ip, port)} (reference ``rpc.py`` read_ip_config)."""
    out = {}
    with open(filename) as f:
        for i, line in enumerate(f):
            parts = line.split()
            if not parts:
                continue
            ip = parts[0]
            port = int(parts[1]) if len(parts) > 1 else 30050
            out[i] = (ip, port)
    return out


def get_local_usable_addr(probe_addr: Optional[str] = None):
    """'ip:free_port' of this host (reference ``rpc.py``
    get_local_usable_addr). The address is the host name's; with
    ``probe_addr`` it is the one a UDP socket would route to that address
    from (the reference always probes 8.8.8.8)."""
    try:
        if probe_addr is None:
            ip = socket.gethostbyname(socket.gethostname())
        else:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.connect((probe_addr, 80))
                ip = s.getsockname()[0]
    except OSError:
        ip = "127.0.0.1"
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s2:
        s2.bind(("", 0))
        port = s2.getsockname()[1]
    return f"{ip}:{port}"


def local_ip4_addr_list():
    """All local IPv4 addresses (reference ``rpc.py``
    local_ip4_addr_list)."""
    addrs = {"127.0.0.1"}
    try:
        hostname = socket.gethostname()
        for info in socket.getaddrinfo(hostname, None, socket.AF_INET):
            addrs.add(info[4][0])
    except OSError:
        pass
    return sorted(addrs)


def alltoall(outputs, inputs, group=None, async_op: bool = False):
    """Host all-to-all over ``torch.distributed`` (reference
    ``dist_dataloader.py`` alltoall): GraphBolt's ``all_to_all``. Device
    traffic rides the mesh's ``all_to_all``."""
    from ..graphbolt.subgraph_sampler import all_to_all

    return all_to_all(outputs, inputs, group=group, async_op=async_op)


# equal-size and variable-size CPU forms (reference alltoall_cpu /
# alltoallv_cpu) share the same host implementation
alltoall_cpu = alltoall


def alltoallv(outputs, inputs, group=None, async_op: bool = False):
    return alltoall(outputs, inputs, group=group, async_op=async_op)


alltoallv_cpu = alltoallv
