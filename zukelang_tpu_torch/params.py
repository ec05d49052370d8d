"""BLS12-381 parameters and the port's limb-32 layout for Fr and Fq.

The port's own copy of the constants of `zukelang_tpu/params.py` (the
curve: moduli, generators, the BLS parameter, the 2-adic root of unity),
written out here, and the Montgomery constants of its 32-bit limbs.
tests/test_torch_params.py holds them against the JAX package.

A field element is a column of 32-bit limbs, least significant first, in
a limb-major `(nl, N)` tensor: Fr has 8 limbs and Fq 12.  The Montgomery
radix stays 2^256 (Fr) and 2^384 (Fq), as in the JAX package's 16-bit
layout, so Montgomery forms repack bit for bit: limb32 = lo | hi << 16.
Tensors hold the uint32 bit pattern in `torch.int32`.
"""

from __future__ import annotations

from typing import List

# Base field modulus (Fq) and scalar field modulus (Fr, the group order)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter x (negative): z = -0xd201000000010000
BLS_X = 0xD201000000010000
BLS_X_IS_NEG = True

# E/Fq : y^2 = x^3 + 4 ; E'/Fq2 : y^2 = x^3 + 4(u+1)
B_G1 = 4
B_G2 = (4, 4)

# Generators (IETF / ZCash standard)
G1_GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_GEN_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_GEN_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# r - 1 = 2^32 * odd; the NTT domains are subgroups of the 2^32-torsion
FR_TWO_ADICITY = 32
FR_GENERATOR = 5      # multiplicative generator of Fr*, also the coset shift
FR_ROOT_OF_UNITY = 0x212D79E5B416B6F0FD56DC8D168D6C0C4024FF270B3E0941B788F500B912F1F

LIMB_BITS = 32
LIMB_MASK = (1 << LIMB_BITS) - 1
FR_LIMBS = 8
FQ_LIMBS = 12


def int_to_limbs(x: int, nl: int) -> List[int]:
    """Python int -> nl limbs of 32 bits, least significant first."""
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(nl)]


class FieldSpec:
    """Static parameters of one prime field's 32-bit limb representation:
    the Montgomery radix R = 2^(32 nl), -p^-1 mod 2^32 (`nprime`), R mod p
    and R^2 mod p."""

    def __init__(self, name: str, p: int, nl: int, nprime: int,
                 r_mod_p: int, r2_mod_p: int):
        self.name = name
        self.p = p
        self.nl = nl
        self.R = 1 << (LIMB_BITS * nl)
        assert self.R > p  # CIOS output < 2p: one conditional subtraction
        assert (p * nprime + 1) % (1 << LIMB_BITS) == 0
        assert r_mod_p == self.R % p and r2_mod_p == self.R * self.R % p
        self.nprime = nprime
        self.r_mod_p = r_mod_p
        self.r2_mod_p = r2_mod_p
        self.p_limbs = int_to_limbs(p, nl)
        self.one_limbs = int_to_limbs(self.r_mod_p, nl)

    def __repr__(self):
        return f"FieldSpec({self.name}, {self.nl} limbs)"


FR = FieldSpec(
    "Fr", R, FR_LIMBS, nprime=0xFFFFFFFF,
    r_mod_p=0x1824B159ACC5056F998C4FEFECBC4FF55884B7FA0003480200000001FFFFFFFE,
    r2_mod_p=0x0748D9D99F59FF1105D314967254398F2B6CEDCB87925C23C999E990F3F29C6D)
FQ = FieldSpec(
    "Fq", P, FQ_LIMBS, nprime=0xFFFCFFFD,
    r_mod_p=0x15F65EC3FA80E4935C071A97A256EC6D77CE5853705257455F48985753C758BAEBF4000BC40C0002760900000002FFFD,
    r2_mod_p=0x11988FE592CAE3AA9A793E85B519952D67EB88A9939D83C08DE5476C4C95B6D50A76E6A609D104F1F4DF1F341C341746)
