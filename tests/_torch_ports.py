"""Free loopback ports for the port's multi-process tests."""

import socket


def free_ports(n):
    """``n`` distinct free ports, all bound before any is released."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()
