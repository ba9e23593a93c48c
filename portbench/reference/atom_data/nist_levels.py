# Frozen copy of stardis_tpu_torch/atom_data/nist_levels.py at commit 9c7d618,
# trimmed to what the benchmark reaches: part of the benchmark's
# plain reference and input generators.  Keep it as it is; the program may change.
"""NIST-derived low-lying level tables for the dominant electron donors.

The reference runs on ``kurucz_cd23_chianti_H_He`` with full level tables
(reference io/base.py:67, conftest.py:60-62).  The builtin dataset needs
no download: it ships transcribed NIST ASD term
tables for the elements that dominate the solar electron budget and the
optical line spectrum: Na, Mg, Al, Si, K, Ca, Ti, Cr, Mn, Fe, Ni (neutral +
first ion where it matters).

Granularity: fine-structure levels where they are thermally resolved at
stellar temperatures (splittings >~ 0.02 eV within ~2 eV of ground), and
term-summed entries (total statistical weight at the term's mean energy)
above that.  Partition-function error vs the full NIST ladder is at the
few-percent level over 3,000-10,000 K — versus the order-10-50% error of
the previous ground-term-only tables (e.g. U(Fe I, 5777 K) ~= 29 with these
tables vs 25 ground-only; published values 26-31).

Each entry is ``(energy_eV, g)`` in increasing energy; level 0 is the
ground state.  Energies are NIST ASD values (term-averaged entries carry
the g-weighted mean of the term's levels, rounded).
"""

from __future__ import annotations

# (Z, ion_charge) -> [(energy_eV, g), ...]
NIST_METAL_LEVELS_EV = {
    # ---- Na I: 3s/3p/4s/3d/4p/5s/4d/4f/5p ladders ----------------------
    (11, 0): [
        (0.0, 2),        # 3s 2S
        (2.1023, 2),     # 3p 2P*_1/2
        (2.1044, 4),     # 3p 2P*_3/2
        (3.1914, 2),     # 4s 2S
        (3.6172, 10),    # 3d 2D
        (3.7526, 6),     # 4p 2P*
        (4.1164, 2),     # 5s 2S
        (4.2836, 10),    # 4d 2D
        (4.2885, 14),    # 4f 2F*
        (4.3447, 6),     # 5p 2P*
        (4.5096, 2),     # 6s 2S
        (4.5869, 10),    # 5d 2D
    ],
    # ---- Mg I ----------------------------------------------------------
    (12, 0): [
        (0.0, 1),        # 3s2 1S
        (2.7091, 1),     # 3s3p 3P*_0
        (2.7115, 3),     # 3s3p 3P*_1
        (2.7166, 5),     # 3s3p 3P*_2
        (4.3458, 3),     # 3s3p 1P*
        (5.1078, 3),     # 3s4s 3S
        (5.3935, 1),     # 3s4s 1S
        (5.7535, 5),     # 3s3d 1D
        (5.9320, 9),     # 3s4p 3P*
        (5.9459, 15),    # 3s3d 3D
        (6.1182, 3),     # 3s4p 1P*
        (6.4310, 3),     # 3s5s 3S
        (6.5163, 1),     # 3s5s 1S
        (6.5886, 5),     # 3s4d 1D
        (6.7193, 15),    # 3s4d 3D
        (6.7276, 21),    # 3s4f 1F*+3F* (term-avg)
    ],
    # ---- Mg II (Na-like) ------------------------------------------------
    (12, 1): [
        (0.0, 2),        # 3s 2S
        (4.4224, 2),     # 3p 2P*_1/2
        (4.4337, 4),     # 3p 2P*_3/2
        (8.6547, 2),     # 4s 2S
        (8.8637, 10),    # 3d 2D
        (9.9952, 6),     # 4p 2P*
    ],
    # ---- Al I -----------------------------------------------------------
    (13, 0): [
        (0.0, 2),        # 3p 2P*_1/2
        (0.013893, 4),   # 3p 2P*_3/2
        (3.1427, 2),     # 4s 2S
        (4.0215, 10),    # 3d 2D
        (4.0870, 6),     # 4p 2P*
        (4.6730, 2),     # 5s 2S
        (4.8270, 10),    # 4d 2D
        (4.8720, 6),     # 5p 2P*
    ],
    # ---- Al II (Mg-like) -------------------------------------------------
    (13, 1): [
        (0.0, 1),        # 3s2 1S
        (4.6404, 9),     # 3s3p 3P* (term-avg 4.635/4.639/4.646)
        (7.4207, 3),     # 3s3p 1P*
        (11.3169, 3),    # 3s4s 3S
    ],
    # ---- Si I ------------------------------------------------------------
    (14, 0): [
        (0.0, 1),        # 3p2 3P_0
        (0.009955, 3),   # 3p2 3P_1
        (0.027697, 5),   # 3p2 3P_2
        (0.7810, 5),     # 3p2 1D
        (1.9087, 1),     # 3p2 1S
        (4.9316, 9),     # 3p4s 3P* (term-avg)
        (5.0823, 3),     # 3p4s 1P*
        (5.6160, 15),    # 3p3d+4p triplet terms ~5.6 (term-avg)
        (5.9537, 9),     # 3p4p terms (term-avg)
        (6.1000, 12),    # higher 4p/3d terms (term-avg)
    ],
    # ---- Si II -----------------------------------------------------------
    (14, 1): [
        (0.0, 2),        # 3p 2P*_1/2
        (0.035613, 4),   # 3p 2P*_3/2
        (5.3220, 12),    # 3s3p2 4P (term-avg)
        (6.8570, 10),    # 3s3p2 2D (term-avg)
        (8.1210, 2),     # 4s 2S
    ],
    # ---- K I -------------------------------------------------------------
    (19, 0): [
        (0.0, 2),        # 4s 2S
        (1.6100, 2),     # 4p 2P*_1/2
        (1.6170, 4),     # 4p 2P*_3/2
        (2.6074, 2),     # 5s 2S
        (2.6701, 10),    # 3d 2D
        (3.0634, 6),     # 5p 2P*
        (3.3970, 10),    # 4d 2D
        (3.4030, 2),     # 6s 2S
        (3.4870, 14),    # 4f 2F*
    ],
    # ---- Ca I ------------------------------------------------------------
    (20, 0): [
        (0.0, 1),        # 4s2 1S
        (1.8794, 1),     # 4s4p 3P*_0
        (1.8858, 3),     # 4s4p 3P*_1
        (1.8989, 5),     # 4s4p 3P*_2
        (2.5229, 15),    # 3d4s 3D (term-avg 2.521/2.523/2.526)
        (2.7091, 5),     # 3d4s 1D
        (2.9325, 3),     # 4s4p 1P*
        (3.9101, 3),     # 4s5s 3S
        (4.1312, 1),     # 4s5s 1S
        (4.4430, 21),    # 3d4p 3F* (term-avg)
        (4.5323, 9),     # 3d4p 3D*? / 4s5p terms (term-avg)
        (4.5540, 3),     # 4s5p 1P*
        (4.6240, 15),    # 3d2/3d4p triplet terms (term-avg)
    ],
    # ---- Ca II -----------------------------------------------------------
    (20, 1): [
        (0.0, 2),        # 4s 2S
        (1.6924, 4),     # 3d 2D_3/2
        (1.7001, 6),     # 3d 2D_5/2
        (3.1233, 2),     # 4p 2P*_1/2
        (3.1512, 4),     # 4p 2P*_3/2
        (6.4680, 2),     # 5s 2S
        (7.0500, 10),    # 4d 2D
    ],
    # ---- Ti I ------------------------------------------------------------
    (22, 0): [
        (0.0, 5),        # 3d2 4s2 a3F_2
        (0.0211, 7),     # a3F_3
        (0.0480, 9),     # a3F_4
        (0.8300, 35),    # 3d3 4s a5F (term-avg 0.813-0.848)
        (0.8997, 5),     # a1D
        (1.0530, 9),     # a3P (term-avg)
        (1.4430, 15),    # a5P (term-avg)
        (1.5020, 9),     # a1G
        (1.8790, 21),    # b3F (term-avg)
        (1.9670, 35),    # z5G*/z5F* 3d2 4s4p terms (term-avg)
        (2.1500, 25),    # b3G? / further even terms (term-avg)
        (2.4000, 35),    # z5D*+ odd terms ~2.4 (term-avg)
    ],
    # ---- Ti II -----------------------------------------------------------
    (22, 1): [
        (0.0, 4),        # 3d2(3F)4s a4F_3/2
        (0.0116, 6),     # a4F_5/2
        (0.0282, 8),     # a4F_7/2
        (0.0487, 10),    # a4F_9/2
        (0.1250, 28),    # 3d3 b4F (term-avg 0.107-0.151)
        (0.5820, 14),    # a2F (term-avg)
        (1.0800, 10),    # a2D (term-avg)
        (1.1240, 18),    # a2G (term-avg)
        (1.1610, 12),    # a4P (term-avg)
        (1.2310, 2),     # a2P? (approx)
        (1.5660, 18),    # b2G? / further doublets (term-avg)
    ],
    # ---- Cr I ------------------------------------------------------------
    (24, 0): [
        (0.0, 7),        # 3d5 4s a7S_3
        (0.9414, 5),     # 3d5 4s a5S_2
        (1.0030, 25),    # 3d4 4s2 a5D (term-avg 0.961-1.030)
        (2.5430, 35),    # a5G (term-avg)
        (2.7100, 15),    # a5P? (term-avg)
        (2.9000, 21),    # z7P* (term-avg 2.89-2.91)
        (3.0110, 27),    # a3G+a5D' even terms (term-avg)
        (3.3210, 21),    # z7F*? (approx)
    ],
    # ---- Cr II -----------------------------------------------------------
    (24, 1): [
        (0.0, 6),        # 3d5 a6S
        (1.5100, 30),    # 3d4(5D)4s a6D (term-avg 1.48-1.55)
        (2.4430, 20),    # a4D (term-avg)
        (2.5440, 36),    # a4G (term-avg)
        (3.1040, 12),    # a4P (term-avg)
    ],
    # ---- Mn I ------------------------------------------------------------
    (25, 0): [
        (0.0, 6),        # 3d5 4s2 a6S
        (2.1780, 30),    # 3d6 4s a6D (term-avg 2.11-2.28)
        (2.9200, 28),    # z8P*+a4D (term-avg)
        (3.0720, 20),    # a4D? (approx)
    ],
    # ---- Mn II -----------------------------------------------------------
    (25, 1): [
        (0.0, 7),        # 3d5 4s a7S
        (1.1740, 5),     # a5S
        (1.8090, 25),    # 3d6? a5D (term-avg)
        (3.4190, 35),    # a5G? (approx)
    ],
    # ---- Fe I ------------------------------------------------------------
    (26, 0): [
        (0.0, 9),        # 3d6 4s2 a5D_4
        (0.0516, 7),     # a5D_3
        (0.0873, 5),     # a5D_2
        (0.1101, 3),     # a5D_1
        (0.1213, 1),     # a5D_0
        (0.8590, 11),    # 3d7 4s a5F_5
        (0.9146, 9),     # a5F_4
        (0.9582, 7),     # a5F_3
        (0.9901, 5),     # a5F_2
        (1.0111, 3),     # a5F_1
        (1.4850, 9),     # 3d7 4s a3F_4
        (1.5574, 7),     # a3F_3
        (1.6079, 5),     # a3F_2
        (2.1980, 15),    # a5P (term-avg 2.176-2.223)
        (2.2790, 9),     # a3P (term-avg)
        (2.4200, 33),    # a3H (term-avg)
        (2.4450, 35),    # 3d6 4s4p z7D* (term-avg 2.40-2.48)
        (2.5600, 21),    # b3F (term-avg)
        (2.8700, 49),    # z7F* (term-avg 2.81-2.99)
        (2.9800, 21),    # z7P* (term-avg)
        (3.0500, 27),    # a3G (term-avg)
        (3.2400, 35),    # b3G+a1.. even terms (term-avg)
        (3.3680, 33),    # z5D*+z5F* head (term-avg)
        (3.5700, 35),    # z5F* (term-avg)
    ],
    # ---- Fe II -----------------------------------------------------------
    (26, 1): [
        (0.0, 10),       # 3d6(5D)4s a6D_9/2
        (0.0477, 8),     # a6D_7/2
        (0.0827, 6),     # a6D_5/2
        (0.1072, 4),     # a6D_3/2
        (0.1212, 2),     # a6D_1/2
        (0.2322, 10),    # 3d7 a4F_9/2
        (0.3012, 8),     # a4F_7/2
        (0.3521, 6),     # a4F_5/2
        (0.3867, 4),     # a4F_3/2
        (1.0320, 20),    # a4D (term-avg 0.986-1.097)
        (1.6950, 12),    # a4P (term-avg)
        (1.9600, 18),    # a2G (term-avg)
        (2.2700, 14),    # a2P+a2D? (approx)
        (2.6350, 10),    # a2D2? (approx)
        (2.8400, 6),     # a6S
        (3.1990, 28),    # b4F? (approx)
    ],
    # ---- Ni I ------------------------------------------------------------
    (28, 0): [
        (0.0, 9),        # 3d8 4s2 a3F_4
        (0.0254, 7),     # 3d9 4s a3D_3
        (0.1095, 5),     # a3D_2
        (0.1655, 7),     # a3F_3
        (0.2122, 3),     # a3D_1
        (0.2754, 5),     # a3F_2
        (0.4230, 5),     # 3d9 4s a1D_2
        (1.6760, 1),     # 3d10 1S
        (1.8260, 5),     # b1D_2?
        (2.7400, 21),    # 3d9 4p z3 terms head (term-avg)
        (3.5400, 27),    # 3d8 4s4p terms (term-avg)
    ],
    # ---- Ni II -----------------------------------------------------------
    (28, 1): [
        (0.0, 6),        # 3d9 2D_5/2
        (0.1870, 4),     # 2D_3/2
        (1.1600, 28),    # 3d8 4s 4F (term-avg 1.04-1.32)
        (1.6800, 14),    # 2F (term-avg)
        (2.8950, 20),    # 4P+2D? (approx)
    ],
}


# ---- CNO + S (neutral + first ion): p-shell elements have sparse level
# structure, so these low-lying tables are nearly exact for U(T) up to
# ~12,000 K (first omitted configurations sit at 6.5-10 eV).  Energies from
# NIST ASD in cm^-1 converted at 8065.544 cm^-1/eV.
NIST_METAL_LEVELS_EV.update({
    # ---- C I: 2p2 3P/1D/1S + 2p2 5S* + 3s + 2p3 3D* -------------------
    (6, 0): [
        (0.0, 1),        # 3P_0
        (0.002035, 3),   # 3P_1 (16.417 cm-1)
        (0.005383, 5),   # 3P_2 (43.414)
        (1.263725, 5),   # 1D_2 (10192.66)
        (2.684011, 1),   # 1S_0 (21648.03)
        (4.182631, 5),   # 5S*_2 (33735.20)
        (7.4860, 9),     # 3s 3P* (term avg ~60373)
        (7.6848, 3),     # 3s 1P*_1 (61981.82)
        (7.9460, 15),    # 2s2p3 3D* (term avg ~64087)
    ],
    # ---- C II ----------------------------------------------------------
    (6, 1): [
        (0.0, 2),        # 2P*_1/2
        (0.007863, 4),   # 2P*_3/2 (63.42)
        (5.3353, 12),    # 2s2p2 4P (term avg ~43032)
        (9.2904, 10),    # 2D (74930/74933)
    ],
    # ---- N I ------------------------------------------------------------
    (7, 0): [
        (0.0, 4),        # 4S*_3/2
        (2.383610, 6),   # 2D*_5/2 (19224.464)
        (2.384690, 4),   # 2D*_3/2 (19233.177)
        (3.575619, 2),   # 2P*_1/2 (28838.920)
        (3.575667, 4),   # 2P*_3/2 (28839.306)
        (10.3290, 12),   # 3s 4P (term avg ~83300)
    ],
    # ---- N II -----------------------------------------------------------
    (7, 1): [
        (0.0, 1),        # 3P_0
        (0.006034, 3),   # 3P_1 (48.67)
        (0.016218, 5),   # 3P_2 (130.80)
        (1.899056, 5),   # 1D_2 (15316.2)
        (4.053119, 1),   # 1S_0 (32688.8)
        (5.800749, 5),   # 5S*_2 (46784.6)
    ],
    # ---- O I ------------------------------------------------------------
    (8, 0): [
        (0.0, 5),        # 3P_2
        (0.019623, 3),   # 3P_1 (158.265)
        (0.028143, 1),   # 3P_0 (226.977)
        (1.967364, 5),   # 1D_2 (15867.862)
        (4.189747, 1),   # 1S_0 (33792.583)
        (9.146240, 5),   # 3s 5S*_2 (73768.2)
        (9.521460, 3),   # 3s 3S*_1 (76794.978)
    ],
    # ---- O II -----------------------------------------------------------
    (8, 1): [
        (0.0, 4),        # 4S*_3/2
        (3.324087, 6),   # 2D*_5/2 (26810.55)
        (3.326569, 4),   # 2D*_3/2 (26830.57)
        (5.017300, 4),   # 2P*_3/2 (40468.01)
        (5.017546, 2),   # 2P*_1/2 (40470.00)
    ],
    # ---- S I ------------------------------------------------------------
    (16, 0): [
        (0.0, 5),        # 3P_2
        (0.049106, 3),   # 3P_1 (396.055)
        (0.071123, 1),   # 3P_0 (573.640)
        (1.145426, 5),   # 1D_2 (9238.609)
        (2.750021, 1),   # 1S_0 (22179.954)
        (6.524542, 5),   # 4s 5S*_2 (52623.640)
        (6.860180, 3),   # 4s 3S*_1 (55330.811)
    ],
    # ---- S II -----------------------------------------------------------
    (16, 1): [
        (0.0, 4),        # 4S*_3/2
        (1.841600, 4),   # 2D*_3/2 (14852.94)
        (1.845541, 6),   # 2D*_5/2 (14884.73)
        (3.040838, 2),   # 2P*_1/2 (24524.83)
        (3.046630, 4),   # 2P*_3/2 (24571.54)
    ],
    # ---- Fe-group SECOND ions: fine-structure 5D/3F ground terms +
    # term-averaged low blocks.  The term-block energies (marked ~) are
    # transcribed to ~0.05 eV; they enter U(T) at the few-percent level.
    # ---- Ti III (3d2) ----------------------------------------------------
    (22, 2): [
        (0.0, 5),        # 3F_2
        (0.022926, 7),   # 3F_3 (184.9)
        (0.048780, 9),   # 3F_4 (393.4)
        (1.050592, 5),   # 1D_2 (8473.5)
        (1.322900, 9),   # 3P (~term avg 10669)
        (1.785213, 9),   # 1G_4 (14398.1)
        (4.026755, 1),   # 1S_0 (32476.6)
    ],
    # ---- Cr III (3d4) ---------------------------------------------------
    (24, 2): [
        (0.0, 1),        # 5D_0
        (0.007861, 3),   # 5D_1 (~63.4)
        (0.022702, 5),   # 5D_2 (~183.1)
        (0.043122, 7),   # 5D_3 (~347.8)
        (0.067919, 9),   # 5D_4 (~547.8)
        (2.12, 9),       # a3P (~term avg)
        (2.19, 33),      # a3H (~term avg)
        (2.29, 21),      # a3F (~term avg)
        (2.566, 27),     # a3G (~term avg)
        (3.31, 13),      # 1I_6 (~)
        (3.385, 15),     # 3D (~term avg)
    ],
    # ---- Fe III (3d6) ---------------------------------------------------
    (26, 2): [
        (0.0, 9),        # 5D_4
        (0.054082, 7),   # 5D_3 (436.2)
        (0.091612, 5),   # 5D_2 (738.9)
        (0.115603, 3),   # 5D_1 (932.4)
        (0.127370, 1),   # 5D_0 (1027.3)
        (2.406, 9),      # a3P2 (~term avg)
        (2.510, 33),     # a3H (~term avg 20245)
        (2.661, 21),     # a3F2 (~term avg 21462)
        (3.092, 27),     # a3G (~term avg 24941)
        (3.7636, 13),    # 1I_6 (30356.2)
        (3.826, 15),     # 3D (~term avg 30857)
    ],
    # ---- Ni III (3d8) ---------------------------------------------------
    (28, 2): [
        (0.0, 9),        # 3F_4
        (0.168706, 7),   # 3F_3 (1360.7)
        (0.281395, 5),   # 3F_2 (2269.6)
        (1.739825, 5),   # 1D_2 (14031.6)
        (2.065894, 5),   # 3P_2 (16661.6)
        (2.136453, 3),   # 3P_1 (17230.7)
        (2.183941, 1),   # 3P_0 (17613.7)
        (2.865336, 9),   # 1G_4 (23109.5)
    ],
    # ---- C III (Be-like 2s2): nearly exact U to ~20,000 K ---------------
    (6, 2): [
        (0.0, 1),        # 2s2 1S_0
        (6.4992, 9),     # 2s2p 3P* (term avg 52367/52391/52447 cm-1)
        (12.6900, 3),    # 2s2p 1P*_1 (102352.0)
    ],
    # ---- N III (B-like 2p) -----------------------------------------------
    (7, 2): [
        (0.0, 2),        # 2p 2P*_1/2
        (0.021626, 4),   # 2p 2P*_3/2 (174.4 cm-1)
        (7.1030, 12),    # 2s2p2 4P (term avg ~57245 cm-1)
        (11.4380, 10),   # 2s2p2 2D (term avg ~92245 cm-1)
    ],
    # ---- O III (C-like 2p2) ----------------------------------------------
    (8, 2): [
        (0.0, 1),        # 3P_0
        (0.014032, 3),   # 3P_1 (113.178 cm-1)
        (0.037964, 5),   # 3P_2 (306.174)
        (2.513566, 5),   # 1D_2 (20273.27)
        (5.354377, 1),   # 1S_0 (43185.74)
        (7.479320, 5),   # 2s2p3 5S*_2 (60324.79)
    ],
    # ---- S III (Si-like 3p2) ----------------------------------------------
    (16, 2): [
        (0.0, 1),        # 3P_0
        (0.037032, 3),   # 3P_1 (298.68 cm-1)
        (0.103290, 5),   # 3P_2 (833.08)
        (1.403900, 5),   # 1D_2 (11322.7)
        (3.367600, 1),   # 1S_0 (27161.0)
        (6.5200, 5),     # 3s3p3 5S*_2 (~52585, approx)
    ],
})

# ---- High-ladder configuration-completion tails (Fe-group neutrals and
# first ions) -----------------------------------------------------------
#
# The transcribed term tables above truncate at ~3-3.6 eV, but the 3d^k
# 4s4p / 3d^(k+1) 4p odd forests and the residual even b/c-terms between
# ~3 and 7 eV carry statistical weights in the HUNDREDS to THOUSANDS
# (exact LS combinatorics: e.g. Fe I 3d6 4s4p = 210 x 12 = 2520
# microstates, Cr I 3d4 4s4p = 2520, Ti I 3d3 4p = 720).  At solar
# temperatures they contribute < 1% to U, but at 10^4 K (kT = 0.86 eV)
# dropping them biases U(T) low by 10-40% — the round-3 hot-star gap
# (reference gets the full ladders from kurucz levels, io/base.py:67).
#
# Each tail entry is one or two pseudo-levels: the RESIDUAL statistical
# weight of the named configurations not already transcribed above,
# placed at the approximate NIST energy centroid of that forest.  This is
# a controlled closure, not a fit: weights are configuration combinatorics
# (minus what the tables already count, minus the part above the
# ionization limit for the neutrals), centroids are read off the NIST ASD
# term structure.  Resulting U(10^4 K) values land inside the published
# full-ladder brackets (PUBLISHED_U_10000K_RANGES below; e.g. modern
# complete-ladder U(Fe I, 10^4 K) ~= 55-65 — Irwin 1981 / Barklem &
# Collet 2016-era values; the older Gray App. D polynomials give ~40 from
# incomplete historical level data).  Appended at the END of each level
# list so existing level numbering (and any line-table references to it)
# is unchanged.
HIGH_LADDER_TAILS_EV = {
    # Ti I: residual even 3d3 4s b-terms + 3d4 (~330 @ ~3.2 eV); odd
    # 3d2 4s4p y-terms + 3d3 4p forest (~1150 @ ~4.6 eV, bound part)
    (22, 0): [(3.2, 330), (4.6, 1150)],
    # Ti II: residual 3d3 / 3d2 4s doublets (~120 @ ~2.5 eV); odd
    # 3d2 4p + 3d 4s4p (~390 @ ~4.2 eV)
    (22, 1): [(2.5, 120), (4.2, 390)],
    # Cr I: residual even 3d4 4s2 + 3d5 4s triplets (~600 @ ~3.8 eV);
    # bound odd 3d5 4p + 3d4 4s4p forest (~1200 @ ~4.8 eV)
    (24, 0): [(3.8, 600), (4.8, 1200)],
    # Cr II: residual even 3d4 4s b-terms + 3d5 doublets (~400 @ ~3.9 eV)
    (24, 1): [(3.9, 400)],
    # Mn I: residual even 3d6 4s quartets (~150 @ ~3.7 eV); bound odd
    # 3d5 4s4p forest (~1200 @ ~5.0 eV)
    (25, 0): [(3.7, 150), (5.0, 1200)],
    # Mn II: residual even 3d5 4s b-terms + 3d6 triplets (~600 @ ~4.3 eV)
    (25, 1): [(4.3, 600)],
    # Fe I: residual even 3d7 4s b/c-terms + 3d6 4s2 singlets
    # (~500 @ ~4.2 eV); bound odd 3d6 4s4p + 3d7 4p forest
    # (~2500 @ ~5.4 eV)
    (26, 0): [(4.2, 500), (5.4, 2500)],
    # Fe II: residual even 3d6 4s b-terms + 3d7 doublets (~410 @ ~3.6 eV);
    # odd 3d6 4p z-forest (~1260 @ ~5.3 eV)
    (26, 1): [(3.6, 410), (5.3, 1260)],
    # Ni I: residual 3d9 4p z-terms (~100 @ ~3.9 eV); bound part of the
    # 3d8 4s4p forest (~450 @ ~5.2 eV)
    (28, 0): [(3.9, 100), (5.2, 450)],
    # Ni II: residual 3d8 4s doublets + 3d7 4s2 (~130 @ ~3.8 eV)
    (28, 1): [(3.8, 130)],
}

for _sp, _tail in HIGH_LADDER_TAILS_EV.items():
    NIST_METAL_LEVELS_EV[_sp] = NIST_METAL_LEVELS_EV[_sp] + _tail

# Published partition-function anchors used by the tests: U(T=5777 K)
# acceptance ranges bracketing the values tabulated in Gray (2005, App. D),
# Irwin (1981) and Allen's Astrophysical Quantities.  These are deliberately
# generous (+-~15%) — the tables above are low-lying transcriptions, not the
# full NIST ladder.

# U(T=10,000 K) anchors.  p-shell CNO/S species stay nearly complete at
# hot-star temperatures (first omitted configurations at 6.5-10 eV
# contribute < 2%); Fe-group third spectra are dominated by the 5D/3F
# ground complexes + transcribed term blocks; Fe-group NEUTRALS and first
# ions get there via the HIGH_LADDER_TAILS_EV configuration-completion
# above — their brackets are the published full-ladder values (Irwin 1981
# / Barklem & Collet 2016-era; NOT the older Gray App. D polynomials,
# whose historical level data bias e.g. Fe I low by ~30%).
PUBLISHED_U_10000K_RANGES = {
    (6, 0): (9.6, 11.2),    # C I
    (6, 1): (5.7, 6.4),     # C II
    (7, 0): (4.4, 5.2),     # N I
    (7, 1): (9.0, 10.0),    # N II
    (8, 0): (9.0, 10.0),    # O I
    (8, 1): (4.0, 4.6),     # O II
    (16, 0): (9.5, 10.9),   # S I
    (16, 1): (5.0, 5.9),    # S II
    (22, 0): (55.0, 75.0),  # Ti I
    (22, 1): (70.0, 92.0),  # Ti II
    (24, 0): (27.0, 37.0),  # Cr I
    (24, 1): (16.0, 22.0),  # Cr II
    (25, 0): (13.0, 18.0),  # Mn I
    (25, 1): (13.0, 19.0),  # Mn II
    (26, 0): (52.0, 66.0),  # Fe I
    (26, 1): (60.0, 76.0),  # Fe II
    (28, 0): (35.0, 44.0),  # Ni I
    (28, 1): (18.0, 24.0),  # Ni II
    (22, 2): (21.0, 27.0),  # Ti III
    (24, 2): (24.0, 31.0),  # Cr III
    (26, 2): (25.0, 32.0),  # Fe III
    (28, 2): (17.0, 21.0),  # Ni III
    (6, 2): (0.98, 1.1),    # C III
    (7, 2): (5.7, 6.2),     # N III
    (8, 2): (8.7, 9.4),     # O III
    (16, 2): (9.0, 9.8),    # S III
}

# Tighter +-10% pins for the Fe-group species whose full-ladder U(10^4 K)
# has solid published central values (round-4 verdict #9).  Central
# values are the Irwin (1981, ApJS 45, 621) polynomial-fit era consensus
# at T = 10^4 K, cross-checked against Barklem & Collet (2016) and
# modern NIST-complete ladders; they are literature transcriptions, not
# fits — re-derive them directly from the Irwin coefficient tables when
# those are at hand, and tighten the
# tolerance if they agree.  These bind the HIGH_LADDER_TAILS_EV
# configuration-completion above: a tail-weight regression that moved
# any of these species by more than 10% fails the pin, not just a wide
# bracket.  Per-species provenance:
#   Ti I  66: 3d2 4s2 a3F ground complex + a5F/a1D/a3P low terms push U
#             steeply; Irwin-era full ladder ~66 (older Gray App. D
#             historical-level value ~49 is known-low).
#   Ti II 82: 3d2 4s a4F ground + dense 3d3/3d2 4p doublet-quartet
#             ladder; full-ladder consensus ~80-84.
#   Cr I  33: 3d5 4s a7S ground (g=7) + a5S/a5D/a5G complexes; the odd
#             z7P/z5P forest at ~3 eV dominates the 10^4 K tail.
#   Cr II 19: 3d5 a6S ground + a6D/a4D; sparse low ladder keeps U small.
#   Fe I  60: 3d6 4s2 a5D + 3d7 4s a5F/a3F low even complexes + the
#             ~2.4-3.7 eV odd z-term forest; Irwin/B&C full ladder
#             ~58-62 at 10^4 K.
#   Fe II 68: 3d6 4s a6D ground + a4F/a4D + 3d7 a4P...; full ladder
#             ~66-70.
