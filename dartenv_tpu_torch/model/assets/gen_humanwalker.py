"""Generator of kima_humanwalker.skel (run offline; its output is the
committed asset, byte for byte):

    python dartenv_tpu_torch/model/assets/gen_humanwalker.py

A reconstruction of the reference's kima humanoid (DartHumanWalkerEnv:
~30 dofs, per-joint action scales 60-160 N m): 29 dofs = free root (6) +
euler spine (3) + per leg euler hip (3) + knee (1) + universal ankle (2)
+ per arm euler shoulder (3) + elbow (1).  Only the feet carry collision
shapes (contacts beyond the feet end the episode through the termination
bounds first).  `generate()` returns the file's text.
"""
import os

HEAD = '''<?xml version="1.0" ?>
<!-- generated by gen_humanwalker.py - do not edit by hand -->
<skel version="1.0">
  <world name="world 1">
    <physics>
      <time_step>0.002</time_step>
      <gravity>0 -9.81 0</gravity>
      <collision_detector>dart</collision_detector>
    </physics>
    <skeleton name="ground skeleton">
      <mobile>false</mobile>
      <body name="ground">
        <transformation>0 -0.05 0 0 0 0</transformation>
        <collision_shape>
          <geometry><box><size>500.0 0.1 10.0</size></box></geometry>
        </collision_shape>
      </body>
      <joint type="weld" name="j_ground">
        <parent>world</parent>
        <child>ground</child>
      </joint>
    </skeleton>
    <skeleton name="kima skeleton">
'''

V = "1.5707963267948966 0 0"  # capsule axis z -> y (vertical)


def body(name, pos, mass, shape, collide=False, inertia=None):
    tag = "collision_shape" if collide else "visualization_shape"
    inert = f"<mass>{mass}</mass><offset>0 0 0</offset>"
    if inertia is not None:
        ixx, iyy, izz = inertia
        inert += (f"<moment_of_inertia><ixx>{ixx}</ixx><iyy>{iyy}</iyy>"
                  f"<izz>{izz}</izz><ixy>0</ixy><ixz>0</ixz><iyz>0</iyz>"
                  "</moment_of_inertia>")
    return f'''      <body name="{name}">
        <transformation>{pos[0]} {pos[1]} {pos[2]} 0 0 0</transformation>
        <inertia>{inert}</inertia>
        <{tag}>
          {shape}
        </{tag}>
      </body>
'''


def capsule(r, h, rot=V):
    return (f'<transformation>0 0 0 {rot}</transformation>'
            f'<geometry><capsule><radius>{r}</radius>'
            f'<height>{h}</height></capsule></geometry>')


def box(hx, hy, hz):
    return (f'<geometry><box><size>{2*hx} {2*hy} {2*hz}</size></box>'
            '</geometry>')


def joint(jtype, name, parent, child, cj, axes):
    s = f'''      <joint type="{jtype}" name="{name}">
        <transformation>{cj[0]} {cj[1]} {cj[2]} 0 0 0</transformation>
        <parent>{parent}</parent>
        <child>{child}</child>
'''
    tags = ["axis", "axis2", "axis3"]
    for i, (xyz, lo, hi, damp) in enumerate(axes):
        s += f'''        <{tags[i]}>
          <xyz>{xyz[0]} {xyz[1]} {xyz[2]}</xyz>
'''
        if lo is not None:
            s += (f'          <limit><lower>{lo}</lower>'
                  f'<upper>{hi}</upper></limit>\n')
        s += (f'          <dynamics><damping>{damp}</damping></dynamics>\n'
              f'        </{tags[i]}>\n')
    s += '      </joint>\n'
    return s


Z, X, Y = (0, 0, 1), (1, 0, 0), (0, 1, 0)


def generate() -> str:
    """The text of kima_humanwalker.skel."""
    s = HEAD
    s += body("pelvis", (0, 1.00, 0), 10.0, box(0.12, 0.08, 0.09))
    s += body("thorax", (0, 1.30, 0), 17.0, capsule(0.11, 0.30),
              inertia=(0.45, 0.25, 0.45))
    for side, sx in (("right", -1.0), ("left", 1.0)):
        z0 = 0.09 * sx
        s += body(f"thigh_{side}", (0, 0.75, z0), 6.0, capsule(0.07, 0.32))
        s += body(f"shin_{side}", (0, 0.335, z0), 3.0, capsule(0.045, 0.35))
        s += body(f"foot_{side}", (0.04, 0.05, z0), 1.5,
                  box(0.13, 0.03, 0.05), collide=True)
    for side, sx in (("right", -1.0), ("left", 1.0)):
        z0 = 0.22 * sx
        s += body(f"uarm_{side}", (0, 1.27, z0), 2.0, capsule(0.045, 0.26))
        s += body(f"farm_{side}", (0, 1.00, z0), 1.2, capsule(0.04, 0.25))

    s += joint("free", "j_root", "world", "pelvis", (0, 0, 0),
               [(X, None, None, 0.0)])
    s += joint("euler", "j_spine", "pelvis", "thorax", (0, -0.18, 0), [
        (X, -0.35, 0.35, 5.0), (Y, -0.6, 0.6, 5.0), (Z, -0.35, 0.35, 5.0),
    ])
    for side, sx in (("right", -1.0), ("left", 1.0)):
        z0 = 0.09 * sx
        s += joint("euler", f"j_hip_{side}", "pelvis", f"thigh_{side}",
                   (0, 0.20, 0), [
            (X, -0.6, 0.6, 2.0), (Y, -0.6, 0.6, 2.0), (Z, -2.0, 0.9, 2.0),
        ])
        s += joint("revolute", f"j_knee_{side}", f"thigh_{side}",
                   f"shin_{side}", (0, 0.215, 0),
                   [(Z, 0.0, 2.6, 2.0)])
        s += joint("universal", f"j_ankle_{side}", f"shin_{side}",
                   f"foot_{side}", (-0.04, 0.07, 0), [
            (Z, -0.8, 0.8, 1.0), (X, -0.5, 0.5, 1.0),
        ])
    for side, sx in (("right", -1.0), ("left", 1.0)):
        s += joint("euler", f"j_shoulder_{side}", "thorax", f"uarm_{side}",
                   (0, 0.15, 0), [
            (X, -1.2, 1.2, 2.0), (Y, -1.0, 1.0, 2.0), (Z, -1.5, 1.5, 2.0),
        ])
        s += joint("revolute", f"j_elbow_{side}", f"uarm_{side}",
                   f"farm_{side}", (0, 0.135, 0),
                   [(Z, -0.01, 2.5, 1.0)])

    s += "    </skeleton>\n  </world>\n</skel>\n"
    return s


def main():
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "kima_humanwalker.skel")
    with open(out, "w") as f:
        f.write(generate())
    print("wrote", out)


if __name__ == "__main__":
    main()
