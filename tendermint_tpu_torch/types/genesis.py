"""Genesis document: the chain's initial conditions.

Reference: `types/genesis.go` — `GenesisDoc{genesis_time, chain_id,
validators[{pub_key, amount, name}], app_hash}` as JSON.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

from tendermint_tpu_torch.types.keys import PubKey
from tendermint_tpu_torch.types.validator import Validator, ValidatorSet


@dataclass
class GenesisValidator:
    pub_key: bytes
    power: int
    name: str = ""


@dataclass
class GenesisDoc:
    chain_id: str
    validators: list[GenesisValidator]
    genesis_time_ns: int = field(
        default_factory=lambda: time.time_ns())
    app_hash: bytes = b""
    app_options: dict = field(default_factory=dict)

    def validator_set(self) -> ValidatorSet:
        return ValidatorSet([
            Validator(PubKey(gv.pub_key), gv.power)
            for gv in self.validators
        ])

    def validate(self) -> None:
        if not self.chain_id:
            raise ValueError("genesis has empty chain_id")
        if not self.validators:
            raise ValueError("genesis has no validators")
        for gv in self.validators:
            if gv.power <= 0:
                raise ValueError(f"validator {gv.name} has power <= 0")

    def to_json(self) -> str:
        return json.dumps({
            "chain_id": self.chain_id,
            "genesis_time_ns": self.genesis_time_ns,
            "app_hash": self.app_hash.hex(),
            "app_options": self.app_options,
            "validators": [
                {"pub_key": gv.pub_key.hex(), "power": gv.power,
                 "name": gv.name}
                for gv in self.validators
            ],
        }, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "GenesisDoc":
        d = json.loads(s)
        doc = cls(
            chain_id=d["chain_id"],
            validators=[
                GenesisValidator(pub_key=bytes.fromhex(v["pub_key"]),
                                 power=int(v["power"]),
                                 name=v.get("name", ""))
                for v in d["validators"]
            ],
            genesis_time_ns=int(d.get("genesis_time_ns", 0)),
            app_hash=bytes.fromhex(d.get("app_hash", "")),
            app_options=d.get("app_options", {}),
        )
        doc.validate()
        return doc

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())
