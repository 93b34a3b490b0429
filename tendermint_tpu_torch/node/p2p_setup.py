"""Node p2p wiring: node key, switch, reactors.

Reference: `node/node.go:135-174` — builds the four reactors
(blockchain, mempool, consensus, pex) and registers them on the Switch;
the node key authenticates every SecretConnection.  Copy of
`tendermint_tpu/node/p2p_setup.py`: the blockchain reactor verifies its
windows on the node's backend, and the address book draws from a
generator of its own.
"""

from __future__ import annotations

import json
import os
import random

from tendermint_tpu_torch import __version__
from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
from tendermint_tpu_torch.mempool.reactor import MempoolReactor
from tendermint_tpu_torch.p2p import AddrBook, NodeInfo, PEXReactor, Switch
from tendermint_tpu_torch.p2p.types import NetAddress
from tendermint_tpu_torch.types.keys import PrivKey


def load_or_gen_node_key(path: str) -> PrivKey:
    """Long-lived p2p identity key, distinct from the validator key
    (reference uses the validator key in this era; separating them is
    standard practice and costs nothing)."""
    if path and os.path.exists(path):
        with open(path) as f:
            return PrivKey(bytes.fromhex(json.load(f)["priv_key"]))
    key = PrivKey.generate()
    if path:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"priv_key": key.seed.hex()}, f)
        os.replace(tmp, path)
    return key


def build_p2p(node) -> Switch:
    cfg = node.config
    base = cfg.base
    key_path = (os.path.join(base.root(), "node_key.json")
                if base.db_backend != "memdb" else "")
    node_key = load_or_gen_node_key(key_path)
    laddr = NetAddress.parse(cfg.p2p.laddr)
    info = NodeInfo(
        pub_key=node_key.pub_key.bytes_, moniker=base.moniker,
        network=node.genesis_doc.chain_id, version=__version__,
        listen_addr=str(laddr))
    sw = Switch(node_key, info, cfg.p2p)

    # fast-sync hands off to consensus via switch_to_consensus
    fast_sync = base.fast_sync and node.state.validators.size() > 1
    cons_reactor = ConsensusReactor(node.consensus, fast_sync=fast_sync)
    if fast_sync:
        bc_reactor = BlockchainReactor(
            node.state.copy(), node.proxy_app.consensus, node.block_store,
            fast_sync=True, backend=node.backend)
        bc_reactor.on_caught_up = cons_reactor.switch_to_consensus
        sw.add_reactor("blockchain", bc_reactor)
    sw.add_reactor("consensus", cons_reactor)
    sw.add_reactor("mempool",
                   MempoolReactor(node.mempool, cfg.mempool.broadcast))
    if cfg.p2p.pex:
        book_path = (os.path.join(base.root(), "addrbook.json")
                     if base.db_backend != "memdb" else "")
        book = AddrBook(book_path, our_addrs={laddr.dial_string()},
                        rng=random.Random())
        sw.add_reactor("pex", PEXReactor(book))
    return sw
