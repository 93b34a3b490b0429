"""UPnP NAT traversal: SSDP discovery, port mapping, external-IP query.

Parity with the reference's taipei-torrent-derived client (reference
`p2p/upnp/upnp.go:1-380`): M-SEARCH over SSDP multicast finds an
InternetGatewayDevice, its description XML yields the WANIPConnection
control URL, and SOAP requests drive GetExternalIPAddress /
AddPortMapping / DeletePortMapping.  `probe` (reference
`p2p/upnp/probe.go:1-113`) exercises the mapping round-trip and reports
capabilities; the `probe_upnp` CLI command prints them (reference
`cmd/tendermint/commands/probe_upnp.go:1-35`).

Everything is stdlib (socket + urllib + ElementTree); the discovery
target is parameterized so tests can run a fake in-process responder
(the reference has no UPnP tests at all).

Copy of `tendermint_tpu/p2p/upnp.py`: the same M-SEARCH datagram, SOAP
envelopes and headers byte for byte, and the same errors.  It runs on
the host alone; no node path calls it (the JAX node does not either),
only `cli probe_upnp`.
"""

from __future__ import annotations

import socket
import urllib.request
from dataclasses import dataclass
from urllib.parse import urljoin, urlparse
from xml.etree import ElementTree

from tendermint_tpu_torch.utils.log import get_logger

log = get_logger("upnp")

SSDP_ADDR = ("239.255.255.250", 1900)
_MSEARCH = (b"M-SEARCH * HTTP/1.1\r\n"
            b"HOST: 239.255.255.250:1900\r\n"
            b"ST: ssdp:all\r\n"
            b'MAN: "ssdp:discover"\r\n'
            b"MX: 2\r\n\r\n")
_IGD = "InternetGatewayDevice:1"
_NS_DEV = "{urn:schemas-upnp-org:device-1-0}"


class UPnPError(Exception):
    pass


def _local_ipv4(probe_target: str) -> str:
    """Source address the OS picks to reach the gateway (the reference's
    localIPv4 interface walk, minus the first-interface guess)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((probe_target, 1900))
        return s.getsockname()[0]
    finally:
        s.close()


def _children(device, tag: str):
    for el in device.iter():
        if el.tag.endswith(tag):
            yield el


def _child_device(device, device_type: str):
    for dl in _children(device, "deviceList"):
        for d in _children(dl, "device"):
            dt = d.findtext(f"{_NS_DEV}deviceType") or d.findtext("deviceType")
            if dt and device_type in dt:
                return d
    return None


def _child_service(device, service_type: str):
    for sl in _children(device, "serviceList"):
        for s in _children(sl, "service"):
            st = (s.findtext(f"{_NS_DEV}serviceType")
                  or s.findtext("serviceType"))
            if st and service_type in st:
                ctl = (s.findtext(f"{_NS_DEV}controlURL")
                       or s.findtext("controlURL"))
                return st, ctl
    return None


@dataclass
class NAT:
    """One discovered gateway (reference `upnpNAT`)."""
    service_url: str
    our_ip: str
    urn_domain: str        # e.g. "schemas-upnp-org"

    def _soap(self, function: str, body: str) -> bytes:
        envelope = (
            '<?xml version="1.0"?>'
            '<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/"'
            ' s:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">'
            "<s:Body>" + body + "</s:Body></s:Envelope>")
        req = urllib.request.Request(
            self.service_url, data=envelope.encode(),
            headers={
                "Content-Type": 'text/xml; charset="utf-8"',
                "User-Agent": "Darwin/10.0.0, UPnP/1.0, MacOSX/10.5.6",
                "SOAPAction":
                    f'"urn:{self.urn_domain}:service:WANIPConnection:1'
                    f'#{function}"',
            }, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                data = resp.read()
                if resp.status != 200:
                    raise UPnPError(f"{function}: HTTP {resp.status}")
                return data
        except OSError as e:
            raise UPnPError(f"{function}: {e}") from None

    def get_external_address(self) -> str:
        body = (f'<u:GetExternalIPAddress xmlns:u='
                f'"urn:{self.urn_domain}:service:WANIPConnection:1"/>')
        data = self._soap("GetExternalIPAddress", body)
        try:
            root = ElementTree.fromstring(data)
        except ElementTree.ParseError as e:
            raise UPnPError(f"malformed SOAP response: {e}") from None
        for el in root.iter():
            if el.tag.endswith("NewExternalIPAddress"):
                if not el.text:
                    break
                return el.text.strip()
        raise UPnPError("no NewExternalIPAddress in response")

    def add_port_mapping(self, protocol: str, external_port: int,
                         internal_port: int, description: str,
                         lease_seconds: int = 0) -> int:
        """Returns the mapped external port (reference AddPortMapping)."""
        body = (
            f'<u:AddPortMapping xmlns:u='
            f'"urn:{self.urn_domain}:service:WANIPConnection:1">'
            f"<NewRemoteHost></NewRemoteHost>"
            f"<NewExternalPort>{external_port}</NewExternalPort>"
            f"<NewProtocol>{protocol.upper()}</NewProtocol>"
            f"<NewInternalPort>{internal_port}</NewInternalPort>"
            f"<NewInternalClient>{self.our_ip}</NewInternalClient>"
            f"<NewEnabled>1</NewEnabled>"
            f"<NewPortMappingDescription>{description}"
            f"</NewPortMappingDescription>"
            f"<NewLeaseDuration>{lease_seconds}</NewLeaseDuration>"
            f"</u:AddPortMapping>")
        self._soap("AddPortMapping", body)
        return external_port

    def delete_port_mapping(self, protocol: str, external_port: int) -> None:
        body = (
            f'<u:DeletePortMapping xmlns:u='
            f'"urn:{self.urn_domain}:service:WANIPConnection:1">'
            f"<NewRemoteHost></NewRemoteHost>"
            f"<NewExternalPort>{external_port}</NewExternalPort>"
            f"<NewProtocol>{protocol.upper()}</NewProtocol>"
            f"</u:DeletePortMapping>")
        self._soap("DeletePortMapping", body)


def _service_url_from_root(root_url: str) -> tuple[str, str]:
    """Fetch the device description and walk IGD -> WANDevice ->
    WANConnectionDevice -> WANIPConnection (reference getServiceURL)."""
    try:
        with urllib.request.urlopen(root_url, timeout=5) as resp:
            data = resp.read()
    except OSError as e:
        raise UPnPError(f"device description fetch failed: {e}") from None
    try:
        tree = ElementTree.fromstring(data)
    except ElementTree.ParseError as e:
        # a rogue responder's bogus description must not escape the
        # module's UPnPError contract (probe/CLI/best-effort callers)
        raise UPnPError(f"malformed device description: {e}") from None
    dev = None
    for el in tree.iter():
        if el.tag.endswith("device"):
            dt = (el.findtext(f"{_NS_DEV}deviceType")
                  or el.findtext("deviceType"))
            if dt and _IGD in dt:
                dev = el
                break
    if dev is None:
        raise UPnPError("no InternetGatewayDevice in description")
    wan = _child_device(dev, "WANDevice:1")
    if wan is None:
        raise UPnPError("no WANDevice")
    conn = _child_device(wan, "WANConnectionDevice:1")
    if conn is None:
        raise UPnPError("no WANConnectionDevice")
    svc = _child_service(conn, "WANIPConnection:1")
    if svc is None:
        raise UPnPError("no WANIPConnection service")
    service_type, control = svc
    if not control:
        raise UPnPError("WANIPConnection service without controlURL")
    # urn:schemas-upnp-org:service:WANIPConnection:1 -> schemas-upnp-org
    urn_domain = service_type.split(":")[1] if ":" in service_type \
        else "schemas-upnp-org"
    if urlparse(control).scheme:
        return control, urn_domain
    return urljoin(root_url, control), urn_domain


def discover(timeout: float = 3.0,
             ssdp_addr: tuple[str, int] | None = None) -> NAT:
    """SSDP M-SEARCH for an InternetGatewayDevice (reference Discover).

    `ssdp_addr` is parameterized so tests can point discovery at a fake
    in-process responder on localhost instead of the multicast group
    (None = the module-level SSDP_ADDR, resolved at call time so tests
    can monkeypatch it).
    """
    if ssdp_addr is None:
        ssdp_addr = SSDP_ADDR
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.settimeout(timeout / 3)
        for _ in range(3):
            sock.sendto(_MSEARCH, ssdp_addr)
            try:
                while True:
                    data, _ = sock.recvfrom(1536)
                    answer = data.decode("latin-1")
                    if _IGD not in answer:
                        continue
                    loc = None
                    for line in answer.split("\r\n"):
                        if line.lower().startswith("location:"):
                            loc = line.split(":", 1)[1].strip()
                            break
                    if not loc:
                        continue
                    service_url, urn_domain = _service_url_from_root(loc)
                    our_ip = _local_ipv4(ssdp_addr[0])
                    return NAT(service_url=service_url, our_ip=our_ip,
                               urn_domain=urn_domain)
            except socket.timeout:
                continue
    finally:
        sock.close()
    raise UPnPError("UPnP port discovery failed")


def probe(int_port: int = 20000, ext_port: int = 20000,
          ssdp_addr: tuple[str, int] | None = None) -> dict:
    """Exercise discovery + external IP + mapping round-trip (reference
    `upnp.Probe`): returns {"port_mapping": bool, "external_ip": str}.
    The reference also dials itself to detect hairpin support; that needs
    a real gateway, so here hairpin is reported only as "untested" unless
    a mapping succeeded and loopback connect works."""
    nat = discover(ssdp_addr=ssdp_addr)
    log.info("upnp discovered", service_url=nat.service_url,
             our_ip=nat.our_ip)
    caps = {"port_mapping": False, "hairpin": False, "external_ip": ""}
    try:
        caps["external_ip"] = nat.get_external_address()
    except UPnPError as e:
        log.info("upnp external address failed", err=str(e))
    try:
        nat.add_port_mapping("tcp", ext_port, int_port,
                             "Tendermint UPnP Probe", 0)
        caps["port_mapping"] = True
        # hairpin: can we reach ourselves through the external address?
        if caps["external_ip"]:
            try:
                srv = socket.create_server(("", int_port))
                srv.settimeout(0.5)
                try:
                    c = socket.create_connection(
                        (caps["external_ip"], ext_port), timeout=0.5)
                    c.close()
                    caps["hairpin"] = True
                except OSError:
                    pass
                finally:
                    srv.close()
            except OSError:
                pass
        nat.delete_port_mapping("tcp", ext_port)
    except UPnPError as e:
        log.info("upnp port mapping failed", err=str(e))
    return caps


def external_listener_address(listen_port: int,
                              ssdp_addr: tuple[str, int] | None = None,
                              description: str = "tendermint-tpu"
                              ) -> tuple[NAT, str] | None:
    """Best-effort: map `listen_port` on the gateway and return
    (nat, "ext_ip:port") for NodeInfo advertisement — the reference's
    `p2p/listener.go` UPnP path.  Returns None when no gateway answers
    (the common case in datacenters); callers fall back to the local
    address."""
    try:
        nat = discover(timeout=1.0, ssdp_addr=ssdp_addr)
        ext_ip = nat.get_external_address()
        nat.add_port_mapping("tcp", listen_port, listen_port, description,
                             lease_seconds=0)
        return nat, f"{ext_ip}:{listen_port}"
    except (UPnPError, OSError):
        return None
